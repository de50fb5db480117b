"""Port parity, GA-RPN's training: vps_torch's ``ga_rpn_loss`` of a
GARPNHead held against vps_tpu's on tests/ga_parity.py's tiny head,
features and gt, seeded weights, the same draws for both samplers (the
shape targets' and the RPN's): every term, the approx and MaxIoU
assignments and both sampled sets equal, each parameter's gradient within
zoo_parity.GRAD_TOL (``assert_train_match``).

The file's only test (pytest-xdist's loadfile scheduler queues a one-test
file after the files with several).
"""

from test_torch_port_threads import one_thread  # noqa: F401  (autouse)
from ga_parity import train_pair
from zoo_parity import assert_train_match


def test_ga_rpn_loss_and_grads_match_jax():
    r = train_pair("GARPNHead")
    assert_train_match(r, {"loss_rpn_cls", "loss_rpn_bbox",
                           "loss_anchor_shape", "loss_anchor_loc"},
                       min_sampled=4)
