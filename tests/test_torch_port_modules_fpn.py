"""Port parity, modules: the FPN neck at R-50's widths, vps_torch against
vps_tpu on the same weights and seeded numpy inputs, on the CPU (the fill,
the weight bridge and the tolerance in ``test_torch_port_modules.py``).

The file's only test, moved out of test_torch_port_modules.py (pytest-
xdist's loadfile scheduler queues a one-test file after the files with
several).
"""

import numpy as np
import jax.numpy as jnp
import torch

from vps_tpu.models.fpn import FPN as JFPN

from test_torch_port_modules import T, _bridge, _close, _nhwc
from test_torch_port_threads import one_thread  # noqa: F401  (autouse)

from vps_torch.models.fpn import FPN


def test_fpn():
    rng = np.random.RandomState(1)
    chans = (256, 512, 1024, 2048)
    xs = [rng.randn(1, 16 >> i, 24 >> i, c).astype(np.float32)
          for i, c in enumerate(chans)]
    jm = JFPN(in_channels=chans)
    pm = FPN(chans, device="cpu")
    v = _bridge(jm, "neck", pm, [jnp.asarray(x) for x in xs])
    want = jm.apply(v, [jnp.asarray(x) for x in xs])
    with torch.no_grad():
        got = pm([T(x).permute(0, 3, 1, 2) for x in xs])
    assert len(got) == 5
    for g, w in zip(got, want):
        _close(_nhwc(g), w)
