"""Port parity, the training slice: every term of vps_tpu's
``PanopticFuseTrack.loss``, from the ``parity`` fixture of
``test_torch_port_train.py`` (the tiny FuseTrack's ``loss`` on both stacks,
same weights, same sampler draws, one jitted value_and_grad on the JAX
side).

It is the file's only test on purpose: pytest-xdist's loadfile scheduler
queues files by their number of tests, most first, so a one-test file starts
after the files with several, off the path of the suite's longest file. The
fixture is module-scoped, so this file builds it for itself.
"""

import numpy as np
import pytest

from test_torch_port_train import SELECTION_FREE, parity  # noqa: F401  (fixture)
from test_torch_port_threads import one_thread  # noqa: F401  (autouse)


def test_loss_terms_match_jax(parity):
    """Every term and metric of ``loss``. The selection-free terms and
    loss_pano (gt boxes only) to rel 1e-4; the post-proposal terms to rel
    1e-3 (equal values mean the same proposals were sampled)."""
    jl, _, tl, _ = parity
    assert set(tl) == set(jl)
    assert jl["loss_cls"] > 0 and jl["loss_mask"] > 0 and jl["loss_match"] > 0
    for k, v in jl.items():
        rel = 1e-4 if k in SELECTION_FREE + ("loss_pano",) else 1e-3
        assert np.isfinite(tl[k])
        assert tl[k] == pytest.approx(v, rel=rel, abs=1e-6), k
