"""Port parity, modules: ResNet-50, vps_torch against vps_tpu on the same
weights and a seeded numpy input, on the CPU (the fill, the weight bridge
and the tolerance in ``test_torch_port_modules.py``).

The file's only test, moved out of test_torch_port_modules.py (pytest-
xdist's loadfile scheduler queues a one-test file after the files with
several).
"""

import numpy as np
import jax
import jax.numpy as jnp
import torch

from vps_tpu.models.resnet import ResNet as JResNet

from test_torch_port_modules import T, _bridge, _close, _nhwc
from test_torch_port_threads import one_thread  # noqa: F401  (autouse)

from vps_torch.models.resnet import ResNet


def test_resnet50():
    x = np.random.RandomState(0).randn(1, 64, 64, 3).astype(np.float32)
    jm = JResNet(depth=50)
    pm = ResNet(50, device="cpu")
    v = _bridge(jm, "backbone", pm, jnp.asarray(x))
    want = jax.jit(jm.apply)(v, jnp.asarray(x))
    with torch.no_grad():
        got = pm(T(x).permute(0, 3, 1, 2))
    assert len(got) == 4
    for g, w in zip(got, want):
        _close(_nhwc(g), w)
