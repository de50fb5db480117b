"""``vps_torch.tools.preset_accuracy`` end to end on the CPU: the synthetic
fixture at 64x128 (5 train videos of 2 frames: 10 steps, one loss line at
the template's log interval of 10; 1 val video), the repo's prepare_data
scripts, then the port's train, test_vpq at two presets and eval_vpq, each
a process of its own, nothing mocked. Its json and table, and its
``epoch_losses`` on the port's train.log equal to the repo tool's. The
file's only test (pytest-xdist's loadfile queues one-test files after the
files with several); the children run on two intra-op threads each (the
chain runs one child at a time, the two presets' chains side by side)."""

import json

from repo_tools import tool
from test_torch_port_threads import one_thread  # noqa: F401  (autouse)

from vps_torch.tools import preset_accuracy


def test_preset_accuracy_chain_on_cpu(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    work = tmp_path / "acc"
    res = preset_accuracy.main([
        "--work_dir", str(work), "--epochs", "1", "--train_videos", "5",
        "--val_videos", "1", "--frames", "2", "--size", "128x64",
        "--presets", "exact,fast-lowres", "--device", "cpu"])
    written = json.loads((work / "preset_accuracy.json").read_text())
    assert set(written) == {"presets", "epochs", "epoch_losses", "fixture",
                            "checkpoint"}
    assert list(written["presets"]) == ["exact", "fast-lowres"]
    for v in written["presets"].values():
        assert set(v) == {"vpq_all", "vpq_thing", "vpq_stuff"}
        assert all(0.0 <= x <= 100.0 for x in v.values())
    assert written["fixture"] == dict(train_videos=5, val_videos=1, frames=2,
                                      size="128x64")
    assert written["checkpoint"].endswith("ckpt_10.pth")
    assert [t for t, _ in res["children"]][:3] == [
        "create_panoptic_labels.py", "create_panoptic_video_labels.py",
        "train"]
    assert len(res["children"]) == 3 + 2 * 2
    out = capsys.readouterr().out
    assert "| preset | fixture VPQ | VPQ-thing | VPQ-stuff |" in out
    assert f"| exact | {written['presets']['exact']['vpq_all']:.2f} |" in out

    log = str(work / "train" / "train.log")
    mine = preset_accuracy.epoch_losses(log)
    assert mine == tool("preset_accuracy").epoch_losses(log)
    assert list(mine) == [1]
    assert {str(k): v for k, v in mine.items()} == written["epoch_losses"]
