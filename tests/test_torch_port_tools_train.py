"""``vps_torch.tools.profile_train`` on the CPU: one train step of the R-50
FuseTrack with the config's bf16 compute knobs (the tool's default) on the
JAX tool's synthetic batch at 224x256 (the recipe's boxes need both sides
over 200), under train_policy: every loss term finite, no step skipped, no
kernel launched off the card. The batch itself is held to the JAX recipe
in ``test_torch_port_tools_parts.py``. The file's only test (pytest-xdist's
loadfile queues one-test files after the files with several)."""

import numpy as np

from test_torch_port_threads import one_thread  # noqa: F401  (autouse)

from vps_torch.tools import profile_train


def test_profile_train_one_cpu_step(capsys):
    out = profile_train.main(["--device", "cpu", "--size", "224x256",
                              "--iters", "0", "--max-gt", "6"])
    logs = out["logs"]
    assert {"loss", "loss_cls", "loss_segm", "loss_match", "loss_pano",
            "loss_rpn_cls", "nonfinite_skips", "lr"} <= set(logs)
    assert all(np.isfinite(v) for v in logs.values())
    assert logs["loss"] > 0 and logs["lr"] == np.float32(0.005)
    assert out["nonfinite_skips"] == 0 and out["step_s"] == []
    assert not any(out["launches"].values())
    text = capsys.readouterr().out
    assert "bf16 compute, 224x256, max_gt 6, cpu" in text
    assert f"loss={logs['loss']:.3f}" in text
