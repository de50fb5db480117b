"""Port, data-parallel training end to end on the CPU:
``vps_torch/tools/dist_train.sh`` with ``NPROC=2`` starts two ranks of
``vps_torch.tools.train`` (explicit rendezvous at localhost, gloo), each
on its shard of the 64x128 synthetic fixture of
``test_torch_port_cli.py`` (1 train video of 2 frames: 1 step an epoch at
one sample a rank), 1 epoch, the validation hook after it (1 val video of
2 frames, on rank 0; the merge on rank 0). The file's only test: pytest-
xdist's loadfile queues files by their number of tests, so it starts late.
"""

import json
import os
import sys

from test_torch_port_cli import CONFIG
from test_torch_port_threads import one_thread  # noqa: F401  (autouse)
from torch_dist_parity import REPO, finish, free_port, start

from vps_torch.data.synth import make_synth_vps

H, W = 64, 128


def test_dist_train_sh_two_ranks_cpu(tmp_path):
    """Both ranks exit 0; one checkpoint; the log says hosts=2 and
    steps/epoch=1, one logged step and one eval of both val frames, and no
    line of rank 1 (it logs at ERROR only); each rank's launch counts file
    is there (all 0: the CPU path launches no kernel)."""
    fix = str(tmp_path / "fixture")
    train_ann, train_img, train_seg = make_synth_vps(
        fix, mode="train", n_videos=1, n_frames=2, H=H, W=W, seed=0,
        first_video=101)
    val_ann, val_img, _ = make_synth_vps(
        fix, mode="val", n_videos=1, n_frames=2, H=H, W=W, seed=1)
    cfg_path = tmp_path / "cfg.py"
    cfg_path.write_text(CONFIG.format(
        base=REPO / "vps_torch/configs/cityscapes/fusetrack.py", W=W, H=H,
        train_ann=train_ann, train_img=train_img, train_seg=train_seg,
        val_ann=val_ann, val_img=val_img))
    work, counts = tmp_path / "work", tmp_path / "counts"
    env = dict(os.environ, NPROC="2", PORT=str(free_port()),
               PYTHON=sys.executable)
    finish([start(["bash", str(REPO / "vps_torch/tools/dist_train.sh"),
                   str(cfg_path), "--work_dir", str(work), "--device", "cpu",
                   "--launch-counts", str(counts)], env=env)], timeout=120)

    ckpts = sorted(p.name for p in work.iterdir() if p.suffix == ".pth")
    assert ckpts == ["ckpt_1.pth"]
    log = (work / "train.log").read_text()
    assert "devices=2 hosts=2 batch/host=1 steps/epoch=1" in log
    assert log.count("Epoch [1][1] time:") == 1
    assert "images/s over 2 rank(s)" in log
    assert log.count("Eval [1] eval_det_frac") == 1
    assert "eval_frames: 2.0000" in log
    for r in (0, 1):
        launches = json.loads((counts / f"launches.rank{r}.json").read_text())
        assert launches and not any(launches.values())
    parts = sorted(p.name for p in (work / ".eval_hook").iterdir())
    assert parts == ["epoch1.host0.pkl", "epoch1.host1.pkl"]
