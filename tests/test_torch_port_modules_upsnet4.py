"""Port parity, modules: the UPSNetFPN semantic head, vps_torch against
vps_tpu on the same weights and seeded numpy inputs, on the CPU (the fill,
the weight bridge and the tolerance in ``test_torch_port_modules.py``).

The file's only test, moved out of test_torch_port_modules.py (pytest-
xdist's loadfile scheduler queues a one-test file after the files with
several).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from vps_tpu.models.panoptic_fpn import UPSNetFPN as JUPSNetFPN

from test_torch_port_modules import T, _bridge, _close, _nhwc
from test_torch_port_threads import one_thread  # noqa: F401  (autouse)

from vps_torch.models.panoptic_fpn import UPSNetFPN


@pytest.mark.parametrize("head_stride,dcn_window", [pytest.param(4, None, id="4")])
def test_upsnet_fpn(head_stride, dcn_window):
    """``dcn_window`` runs every level through the clamped DCN, at narrow
    widths (64 -> 32 channels; GroupNorm(32) still has two and one
    channels a group)."""
    cin, cout = (256, 128) if dcn_window is None else (64, 32)
    rng = np.random.RandomState(4)
    xs = [rng.randn(1, 16 >> i, 32 >> i, cin).astype(np.float32)
          for i in range(4)]
    kw = dict(in_channels=cin, out_channels=cout, compute_dtype=None,
              head_stride=head_stride, dcn_window=dcn_window)
    jm = JUPSNetFPN(**kw)
    pm = UPSNetFPN(device="cpu", **kw)
    v = _bridge(jm, "panopticFPN", pm, [jnp.asarray(x) for x in xs])
    want_out, want_score = jax.jit(jm.apply)(v, [jnp.asarray(x) for x in xs])
    with torch.no_grad():
        out, score = pm([T(x).permute(0, 3, 1, 2) for x in xs])
    _close(_nhwc(score), want_score)
    _close(_nhwc(out), want_out)
