"""Port parity, the single-stage detectors' training: vps_torch's FCOS
``loss`` held against vps_tpu's on tests/single_parity.py's tiny config,
image and gt, seeded weights, the bar of ``zoo_parity.assert_train_match``
(every term within SINGLE_REL of JAX's, each parameter's gradient within
zoo_parity.GRAD_TOL) with every assignment both stacks make equal slot for
slot (single_parity.train_pair records them).

The file's only test (pytest-xdist's loadfile scheduler queues a one-test
file after the files with several).
"""

from test_torch_port_threads import one_thread  # noqa: F401  (autouse)
from single_parity import SINGLE_REL, TRAIN_CFGS, train_pair
from zoo_parity import assert_train_match


def test_single_train_fcos_loss_and_grads_match_jax():
    r = train_pair("FCOS", TRAIN_CFGS["FCOS"])
    assert_train_match(r, set(r["jl"]), min_sampled=1, rel=SINGLE_REL)
