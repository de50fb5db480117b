"""Port parity, the training slice: the gradients of the selection-free
loss terms against ``jax.grad``, from the ``parity`` fixture of
``test_torch_port_train.py`` (the tiny FuseTrack's ``loss`` on both stacks,
same weights, same sampler draws, one jitted value_and_grad on the JAX
side).

It is the file's only test on purpose: pytest-xdist's loadfile scheduler
queues files by their number of tests, most first, so a one-test file starts
after the files with several, off the path of the suite's longest file. The
fixture is module-scoped, so this file builds it for itself.
"""

import numpy as np

from test_torch_port_train import parity  # noqa: F401  (fixture)
from test_torch_port_threads import one_thread  # noqa: F401  (autouse)


def test_selection_free_gradients_match_jax(parity):
    """Gradients of loss_segm + loss_rpn_cls + loss_rpn_bbox for every
    trainable parameter (backbone stages 2-4, FPN, fuse neck through the
    correlation backward, semantic head, RPN): each within 5e-3 of its
    tensor's largest JAX gradient plus 1e-6 of the largest over all tensors
    (f32 sums in other orders; measured at most 1e-3, at TCEA's attention
    convs, whose gradients nearly cancel, and 1e-4 elsewhere). The heads
    after the proposals get none."""
    _, jg, _, grads = parity
    gmax = max(np.abs(jg[n].numpy()).max() for n, g in grads.items()
               if g is not None)
    reached = 0
    for name, g in grads.items():
        ref = jg[name].numpy()
        if g is None:
            assert not ref.any(), name
            continue
        err = np.abs(g.numpy() - ref).max()
        assert err <= 5e-3 * np.abs(ref).max() + 1e-6 * gmax, (name, err)
        reached += 1
    assert reached > 100
    assert grads["extra_neck.liteflownet.flow_estimator.convs.0.0.weight"] \
        is not None
    assert grads["bbox_head.fc_cls.weight"] is None
