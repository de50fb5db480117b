"""``vps_torch.tools.get_flops`` on the tiny FuseTrack config (ResNet-18,
TinyFlow) at 64x128 on the CPU: its parameter count equals the JAX tool's
(``jax.eval_shape`` of ``init`` through ``predict``, the same call as
``tools/get_flops.py``), the FLOPs the counter gives the FPN's convolutions
equal their analytic count, and the correlation's added count is
2 * C * D^2 * H * W at its call's shape. The file's only test (pytest-
xdist's loadfile queues one-test files after the files with several)."""

import jax
import jax.numpy as jnp
import numpy as np

from test_torch_port_threads import one_thread  # noqa: F401  (autouse)

from vps_tpu import zoo as jzoo
from vps_tpu.models import build_detector as jbuild_detector
from vps_tpu.models.detectors import empty_track_state as jempty_track_state

from vps_torch.tools import get_flops

H, W = 64, 128
CONFIG = """
_base_ = r"{base}"
from vps_torch import zoo

model = zoo.tiny_overrides(zoo.fusetrack_model_cfg())
train_cfg = zoo.tiny_train_cfg()
test_cfg = zoo.tiny_test_cfg()
"""


def test_get_flops_tiny_config(tmp_path, capsys):
    cfg_path = tmp_path / "tiny.py"
    base = get_flops.__file__.rsplit("/tools/", 1)[0]
    cfg_path.write_text(CONFIG.format(
        base=f"{base}/configs/cityscapes/fusetrack.py"))
    got = get_flops.main([str(cfg_path), "--shape", str(H), str(W),
                          "--device", "cpu"])

    det = jbuild_detector(jzoo.tiny_overrides(jzoo.fusetrack_model_cfg()),
                          train_cfg=jzoo.tiny_train_cfg(),
                          test_cfg=jzoo.tiny_test_cfg())
    img = jnp.zeros((1, H, W, 3), jnp.float32)
    shapes = jax.eval_shape(lambda: det.init(
        {"params": jax.random.PRNGKey(0)}, img, img,
        jempty_track_state(cap=256), method=det.predict))
    n_jax = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(shapes["params"]))
    assert got["params"] == n_jax
    out = capsys.readouterr().out
    assert f"params: {n_jax / 1e6:.2f} M" in out

    # the FPN (ResNet-18's C2-C5 of 64-512 channels, 256 out): a 1x1
    # lateral and a 3x3 output conv a level, for the frame and its
    # reference (predict recomputes the reference pyramid); P6 is a pool
    sizes = [(H // 4 >> i, W // 4 >> i) for i in range(4)]
    per_frame = sum(2 * cin * 256 * h * w + 2 * 9 * 256 * 256 * h * w
                    for cin, (h, w) in zip((64, 128, 256, 512), sizes))
    assert got["by_module"]["FPN"] == 2 * per_frame

    # LiteFlowNetCorr on the 1/4 level, 256 channels, md 4: one call
    (shape, md, s2, flops), = got["correlation_calls"]
    assert (shape, md, s2) == ((1, H // 4, W // 4, 256), 4, 1)
    assert flops == got["correlation"] == 2.0 * 256 * 81 * (H // 4) * (W // 4)
    assert got["flops"] == got["counted"] + got["correlation"]
    assert got["counted"] > got["by_module"]["FPN"]
