"""Port parity, modules: the RPN head, its anchors and rpn_proposals,
vps_torch against vps_tpu on the same weights and seeded numpy inputs, on
the CPU (the fill, the weight bridge and the tolerance in
``test_torch_port_modules.py``).

The file's only test, moved out of test_torch_port_modules.py (pytest-
xdist's loadfile scheduler queues a one-test file after the files with
several).
"""

import numpy as np
import jax
import jax.numpy as jnp
import torch

from vps_tpu.models.rpn_head import RPNHead as JRPNHead
from vps_tpu.models.rpn_head import rpn_proposals as j_rpn_proposals
from vps_tpu.ops.anchors import AnchorGenerator as JAnchorGenerator

from test_torch_port_modules import T, _bridge, _close, _nhwc
from test_torch_port_threads import one_thread  # noqa: F401  (autouse)

from vps_torch.models.rpn_head import (
    RPNHead,
    rpn_proposals,
)
from vps_torch.ops.anchors import AnchorGenerator


def test_rpn_head_and_proposals():
    rng = np.random.RandomState(5)
    h, w = 64, 96
    xs = [rng.randn(1, h // s, w // s, 256).astype(np.float32)
          for s in (4, 8, 16, 32, 64)]
    jm = JRPNHead()
    pm = RPNHead(device="cpu")
    v = _bridge(jm, "rpn_head", pm, [jnp.asarray(x) for x in xs])
    jcls, jreg = jax.jit(jm.apply)(v, [jnp.asarray(x) for x in xs])
    with torch.no_grad():
        pcls, preg = pm([T(x).permute(0, 3, 1, 2) for x in xs])
    for g, wnt in zip(pcls + preg, list(jcls) + list(jreg)):
        _close(_nhwc(g), wnt)
    strides = (4, 8, 16, 32, 64)
    janchors = [JAnchorGenerator(s, [8], [0.5, 1.0, 2.0]).grid_anchors(
        c.shape[1:3], s) for s, c in zip(strides, jcls)]
    panchors = [AnchorGenerator(s, [8], [0.5, 1.0, 2.0]).grid_anchors(
        tuple(c.shape[-2:]), s) for s, c in zip(strides, pcls)]
    for pa, ja in zip(panchors, janchors):
        np.testing.assert_array_equal(pa.numpy(), np.asarray(ja))
    # feed both decoders the SAME (JAX) head outputs: selection is discrete
    want = jax.jit(lambda c, r, a: j_rpn_proposals(
        c, r, a, (h, w), nms_pre=200, max_num=100))(
        [c[0] for c in jcls], [r[0] for r in jreg], janchors)
    got = rpn_proposals([T(np.array(c[0])) for c in jcls],
                        [T(np.array(r[0])) for r in jreg], panchors, (h, w),
                        nms_pre=200, max_num=100)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=1e-4)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), atol=1e-6)
