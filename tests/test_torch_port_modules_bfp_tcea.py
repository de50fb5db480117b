"""Port parity, modules: the BFPTcea fuse neck, vps_torch against vps_tpu on
the same weights and seeded numpy inputs, on the CPU (the fill, the weight
bridge and the tolerance in ``test_torch_port_modules.py``).

The file's only test, moved out of test_torch_port_modules.py (pytest-
xdist's loadfile scheduler queues a one-test file after the files with
several).
"""

import numpy as np
import jax
import jax.numpy as jnp
import torch

from vps_tpu.models.bfp_tcea import BFPTcea as JBFPTcea

from test_torch_port_modules import T, _bridge, _close, _nhwc
from test_torch_port_threads import one_thread  # noqa: F401  (autouse)

from vps_torch.models.bfp_tcea import BFPTcea


def test_bfp_tcea():
    rng = np.random.RandomState(3)
    sizes = [(16, 32), (8, 16), (4, 8), (2, 4), (1, 2)]
    cur = [rng.randn(1, h, w, 256).astype(np.float32) for h, w in sizes]
    ref = [rng.randn(1, h, w, 256).astype(np.float32) for h, w in sizes]
    flow = rng.uniform(-2, 2, (1, 16, 32, 2)).astype(np.float32)
    jm = JBFPTcea(compute_dtype=None)
    pm = BFPTcea(compute_dtype=None, device="cpu")
    jargs = ([jnp.asarray(x) for x in cur], [jnp.asarray(x) for x in ref],
             jnp.asarray(flow))
    v = _bridge(jm, "extra_neck", pm, *jargs)
    want = jax.jit(jm.apply)(v, *jargs)
    nchw = lambda xs: [T(x).permute(0, 3, 1, 2) for x in xs]  # noqa: E731
    with torch.no_grad():
        got = pm(nchw(cur), nchw(ref), T(flow))
    for g, w in zip(got, want):
        _close(_nhwc(g), w)
