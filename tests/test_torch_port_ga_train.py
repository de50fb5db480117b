"""Port parity, guided anchoring's training: vps_torch's ``ga_loss`` of a
GuidedAnchorHead held against vps_tpu's on tests/ga_parity.py's tiny head,
features and gt (three valid of four, two overlapping), seeded weights,
the same sampler draws: every term (loc, shape, cls, bbox), the approx and
MaxIoU assignments and the shape sampler's slots equal, each parameter's
gradient within zoo_parity.GRAD_TOL (``assert_train_match``).

The file's only test (pytest-xdist's loadfile scheduler queues a one-test
file after the files with several): JAX's compile of the loss and its
gradient through the head's deformable convs takes most of its time.
"""

from test_torch_port_threads import one_thread  # noqa: F401  (autouse)
from ga_parity import train_pair
from zoo_parity import assert_train_match


def test_ga_loss_and_grads_match_jax():
    r = train_pair("GuidedAnchorHead")
    assert_train_match(r, {"loss_cls", "loss_bbox", "loss_shape",
                           "loss_loc"}, min_sampled=3)
