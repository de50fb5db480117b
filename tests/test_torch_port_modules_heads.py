"""Port parity, modules: the bbox, mask and track heads, vps_torch against
vps_tpu on the same weights and seeded numpy inputs, on the CPU (the fill,
the weight bridge and the tolerance in ``test_torch_port_modules.py``).

The file's only test, moved out of test_torch_port_modules.py (pytest-
xdist's loadfile scheduler queues a one-test file after the files with
several).
"""

import numpy as np
import jax.numpy as jnp
import torch

from vps_tpu.models.bbox_head import SharedFCBBoxHead as JBBoxHead
from vps_tpu.models.mask_head import FCNMaskHead as JMaskHead
from vps_tpu.models.track_head import TrackHead as JTrackHead

from test_torch_port_modules import T, _bridge, _close, _nhwc
from test_torch_port_threads import one_thread  # noqa: F401  (autouse)

from vps_torch.models.bbox_head import SharedFCBBoxHead
from vps_torch.models.mask_head import FCNMaskHead
from vps_torch.models.track_head import TrackHead


def test_bbox_mask_track_heads():
    rng = np.random.RandomState(6)
    r7 = rng.randn(5, 7, 7, 256).astype(np.float32)
    r14 = rng.randn(3, 14, 14, 256).astype(np.float32)
    ref7 = rng.randn(4, 7, 7, 256).astype(np.float32)
    ref_valid = np.array([True, False, True, True])

    jb, pb = JBBoxHead(), SharedFCBBoxHead(device="cpu")
    v = _bridge(jb, "bbox_head", pb, jnp.asarray(r7))
    want_cls, want_reg = jb.apply(v, jnp.asarray(r7))
    jm, pmh = JMaskHead(), FCNMaskHead(device="cpu")
    vm = _bridge(jm, "mask_head", pmh, jnp.asarray(r14))
    want_mask = jm.apply(vm, jnp.asarray(r14))
    jt, pt = JTrackHead(), TrackHead(device="cpu")
    vt = _bridge(jt, "track_head", pt, jnp.asarray(r7), jnp.asarray(ref7),
                 jnp.asarray(ref_valid))
    want_match = jt.apply(vt, jnp.asarray(r7), jnp.asarray(ref7),
                          jnp.asarray(ref_valid))
    with torch.no_grad():
        cls, reg = pb(T(r7))
        mask = pmh(T(r14))
        match = pt(T(r7), T(ref7), T(ref_valid))
    _close(cls.numpy(), want_cls)
    _close(reg.numpy(), want_reg)
    _close(_nhwc(mask), want_mask)
    _close(match.numpy(), want_match)
