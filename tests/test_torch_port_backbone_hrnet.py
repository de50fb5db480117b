"""Port parity, HRNet into HRFPN: tests/test_two_stage.py's tiny HRNet
(one module a stage, branches 8-64 wide) and an HRFPN to 32 channels,
against vps_tpu's on a seeded 64x64 image: the four branches and the five
pyramid levels each within 1e-4 of their largest value.
"""

import numpy as np
import jax
import jax.numpy as jnp
import torch

from vps_tpu.registry import NECKS as JNECKS

from backbone_parity import (
    HR_TINY,
    assert_close_to_largest,
    backbone_pair,
    port_state,
    variables,
)
from test_torch_port_threads import one_thread  # noqa: F401  (autouse)

from vps_torch.registry import NECKS


def test_hrnet_into_hrfpn_matches_jax():
    want, got, port = backbone_pair("HRNet", "HRNet", dict(extra=HR_TINY))
    assert [g.shape for g in got] == [(1, 16, 16, 8), (1, 8, 8, 16),
                                      (1, 4, 4, 32), (1, 2, 2, 64)]
    assert_close_to_largest(got, want, 1e-4)
    kw = dict(in_channels=(8, 16, 32, 64), out_channels=32, num_outs=5)
    jneck = JNECKS.get("HRFPN")(**kw)
    feats = tuple(jnp.asarray(w) for w in want)
    v = variables(jneck, feats, 1)
    jout = jax.jit(lambda v, f: jneck.apply(v, f))(v, feats)
    neck = NECKS["HRFPN"](device="cpu", **kw)
    neck.load_state_dict(port_state(("neck",), v, "neck"), strict=True)
    with torch.no_grad():
        tout = neck([torch.from_numpy(g).permute(0, 3, 1, 2) for g in got])
    assert_close_to_largest([t.permute(0, 2, 3, 1).numpy() for t in tout],
                            [np.asarray(j) for j in jout], 1e-4)
