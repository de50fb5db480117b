"""Port parity, modules: panoptic_dets, mask_removal_and_fuse and
track_assign, vps_torch against vps_tpu on the same weights and seeded
numpy inputs, on the CPU (the fill, the weight bridge and the tolerance in
``test_torch_port_modules.py``).

The file's only test, moved out of test_torch_port_modules.py (pytest-
xdist's loadfile scheduler queues a one-test file after the files with
several).
"""

import functools
import numpy as np
import jax
import jax.numpy as jnp
import torch

from vps_tpu.models.detectors.panoptic_ops import (
    TrackState as JTrackState,
    mask_removal_and_fuse as j_mask_removal_and_fuse,
    panoptic_dets as j_panoptic_dets,
    track_assign as j_track_assign,
)

from test_torch_port_modules import T
from test_torch_port_threads import one_thread  # noqa: F401  (autouse)

from vps_torch.models.detectors.panoptic_ops import (
    TrackState,
    mask_removal_and_fuse,
    panoptic_dets,
    track_assign,
)


def test_panoptic_tail_ops():
    """panoptic_dets, mask_removal_and_fuse and track_assign on identical
    inputs: identical selections, keep sets, maps and track ids."""
    rng = np.random.RandomState(7)
    n, k = 40, 9
    xy = rng.uniform(0, 80, (n, 2))
    rois = np.concatenate([xy, xy + rng.uniform(8, 40, (n, 2))], 1
                          ).astype(np.float32)
    valid = rng.rand(n) > 0.1
    prob = rng.dirichlet(np.full(k, 0.3), n).astype(np.float32)
    deltas = (rng.randn(n, 4 * k) * 0.5).astype(np.float32)
    jd = jax.jit(functools.partial(j_panoptic_dets, img_shape=(96, 128),
                                   score_thresh=0.3, top_n=16))(
        jnp.asarray(rois), jnp.asarray(valid), jnp.asarray(prob),
        jnp.asarray(deltas))
    pd = panoptic_dets(T(rois), T(valid), T(prob), T(deltas), (96, 128),
                       score_thresh=0.3, top_n=16)
    np.testing.assert_array_equal(pd[3].numpy(), np.asarray(jd[3]))
    np.testing.assert_array_equal(pd[2].numpy(), np.asarray(jd[2]))
    np.testing.assert_allclose(pd[0].numpy(), np.asarray(jd[0]), atol=1e-4)
    boxes, probs, cls, dvalid = (np.array(a) for a in jd)
    assert dvalid.sum() >= 4

    cap = 8
    comp = rng.randn(16, cap + 1).astype(np.float32)
    mem_valid = np.arange(cap) < 5
    comp[:, 1:][:, ~mem_valid] = -np.inf
    comp[3, 2] = comp[5, 2] = 50.0  # two dets compete for memory slot 1
    feats = rng.randn(16, 7, 7, 4).astype(np.float32)
    labels = rng.randint(0, 8, 16).astype(np.int32)
    st = (rng.randn(cap, 7, 7, 4).astype(np.float32),
          rng.uniform(0, 50, (cap, 4)).astype(np.float32),
          rng.randint(0, 8, cap).astype(np.int32), mem_valid, np.int32(5))
    jids, jst = jax.jit(j_track_assign)(
        jnp.asarray(comp), jnp.asarray(boxes), jnp.asarray(labels),
        jnp.asarray(feats), jnp.asarray(dvalid),
        JTrackState(*(jnp.asarray(a) for a in st)))
    pids, pst = track_assign(T(comp), T(boxes), T(labels), T(feats), T(dvalid),
                             TrackState(*(torch.as_tensor(a) for a in st)))
    np.testing.assert_array_equal(pids.numpy(), np.asarray(jids))
    for a, b in zip(pst, jst):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    mask28 = rng.randn(16, 28, 28).astype(np.float32)
    fcn = rng.randn(96, 128, 19).astype(np.float32)
    jf = jax.jit(j_mask_removal_and_fuse)(
        jnp.asarray(boxes), jnp.asarray(probs), jnp.asarray(cls),
        jnp.asarray(dvalid), jids, jnp.asarray(mask28), jnp.asarray(fcn))
    pf = mask_removal_and_fuse(
        T(boxes), T(probs), T(cls), T(dvalid), pids, T(mask28),
        T(np.ascontiguousarray(fcn.transpose(2, 0, 1))))
    assert int(pf.num_keep) == int(jf.num_keep) >= 2
    for a, b in zip(pf, jf):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
