"""Port parity, modules: the half-flow trunk, ResNet-18 + FPN computing in
bf16, vps_torch against vps_tpu on the same weights and seeded numpy
inputs, on the CPU (the fill, the weight bridge and the tolerance in
``test_torch_port_modules.py``).

The file's only test, moved out of test_torch_port_modules.py (pytest-
xdist's loadfile scheduler queues a one-test file after the files with
several).
"""

import numpy as np
import jax
import jax.numpy as jnp
import torch

from vps_tpu.models.fpn import FPN as JFPN
from vps_tpu.models.resnet import ResNet as JResNet

from test_torch_port_modules import T, _bridge, _nhwc
from test_torch_port_threads import one_thread  # noqa: F401  (autouse)

from vps_torch.models.fpn import FPN
from vps_torch.models.resnet import ResNet


def test_resnet18_fpn_bf16():
    """The half-flow trunk: ResNet + FPN computing in bf16 (params f32, FPN
    outputs f32). Both sides round every conv output to bf16 (2^-8
    relative) but accumulate in another order, so results drift by bf16
    ulps over the ~20 bf16 layers: mean |diff| <= 2% of mean |ref|, max
    |diff| <= 3% of max |ref|."""
    rng = np.random.RandomState(8)
    x = rng.randn(1, 64, 96, 3).astype(np.float32)
    jr, jf = JResNet(depth=18, dtype=jnp.bfloat16), JFPN(
        in_channels=(64, 128, 256, 512), dtype=jnp.bfloat16)
    pr = ResNet(18, dtype=torch.bfloat16, device="cpu")
    pf = FPN((64, 128, 256, 512), dtype=torch.bfloat16, device="cpu")
    vr = _bridge(jr, "backbone", pr, jnp.asarray(x))
    c = jax.jit(jr.apply)(vr, jnp.asarray(x))
    vf = _bridge(jf, "neck", pf, list(c))
    want = jax.jit(jf.apply)(vf, list(c))
    with torch.no_grad():
        got = pf(pr(T(x).permute(0, 3, 1, 2)))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        g, w = _nhwc(g), np.asarray(w)
        d = np.abs(g - w)
        assert d.mean() <= 2e-2 * np.abs(w).mean(), d.mean()
        assert d.max() <= 3e-2 * np.abs(w).max(), d.max()
