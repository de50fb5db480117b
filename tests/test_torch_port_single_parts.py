"""Port parity, the single-stage detectors' parts: the SSD anchor plan for
SSD300 and SSD512, AnchorGenerator's defaults, RepPoints' three point-set
transforms (and the moment transfer's gradient blend), the focal and IoU
losses with their gradients, and ``point_assign`` with built ties, a
repeated gt and invalid gts, each against vps_tpu's on the CPU: anchors
and assignments exactly, values within 1e-6 relative.

Cheap tests; the detectors' own files hold the whole paths.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from vps_tpu.core.assigner import point_assign as j_point_assign
from vps_tpu.models.anchor_heads import (
    ssd_anchor_generators as j_ssd_anchor_generators,
)
from vps_tpu.models.reppoints import RepPointsHead as JRepPointsHead
from vps_tpu.models.reppoints import points2bbox as j_points2bbox
from vps_tpu.ops.anchors import AnchorGenerator as JAnchorGenerator
from vps_tpu.ops.losses import iou_loss as j_iou_loss
from vps_tpu.ops.losses import sigmoid_focal_loss as j_focal

from test_torch_port_threads import one_thread  # noqa: F401  (autouse)

from vps_torch.core.assigner import point_assign
from vps_torch.models.anchor_heads import ssd_anchor_generators
from vps_torch.models.reppoints import points2bbox
from vps_torch.ops.anchors import AnchorGenerator
from vps_torch.ops.losses import iou_loss, sigmoid_focal_loss

SSD512_RATIOS = ([2], [2, 3], [2, 3], [2, 3], [2, 3], [2], [2])
SSD512_STRIDES = (8, 16, 32, 64, 128, 256, 512)


@pytest.mark.parametrize("size,ratio_range", [
    (300, (0.15, 0.9)), (300, (0.2, 0.9)), (512, (0.1, 0.9)),
    (512, (0.15, 0.9))])
def test_ssd_anchor_plan_matches_jax(size, ratio_range):
    kw = (dict(basesize_ratio_range=ratio_range) if size == 300 else dict(
        num_levels=7, strides=SSD512_STRIDES, anchor_ratios=SSD512_RATIOS,
        basesize_ratio_range=ratio_range))
    want = j_ssd_anchor_generators(size, **kw)
    got = ssd_anchor_generators(size, **kw)
    assert len(got) == len(want) == (6 if size == 300 else 7)
    for g, j in zip(got, want):
        np.testing.assert_array_equal(g.base_anchors, j.base_anchors)
    # the grid of the first level (the grid code is every level's)
    np.testing.assert_array_equal(got[0].grid_anchors((5, 4), 8).numpy(),
                                  np.asarray(want[0].grid_anchors((5, 4), 8)))
    if size == 300:  # the floor-mode pyramid's levels: 8096 anchors
        sides = (37, 18, 9, 5, 3, 1)
        assert sum(g.num_base_anchors * n * n
                   for g, n in zip(got, sides)) == 8096


def test_anchor_generator_defaults_unchanged():
    """The defaults (ratio-major, centre 0.5 (s - 1)) give vps_tpu's
    anchors, and the RPN's stride-4 anchors of before."""
    for base, scales, ratios in ((4, [8], [0.5, 1.0, 2.0]),
                                 (16, [4 * 2 ** (i / 3) for i in range(3)],
                                  [0.5, 1.0, 2.0]), (7, [1.0, 2.5], [1.0])):
        got = AnchorGenerator(base, scales, ratios)
        want = JAnchorGenerator(base, scales, ratios)
        np.testing.assert_array_equal(got.base_anchors, want.base_anchors)
        np.testing.assert_array_equal(
            got.grid_anchors((3, 5), base).numpy(),
            np.asarray(want.grid_anchors((3, 5), base)))
    np.testing.assert_array_equal(
        AnchorGenerator(4, [8], [0.5, 1.0, 2.0]).base_anchors,
        [[-21, -9, 24, 12], [-14, -14, 17, 17], [-9, -21, 12, 24]])


@pytest.mark.parametrize("method", ["minmax", "partial_minmax", "moment"])
def test_points2bbox_matches_jax(method):
    """Values and the points' gradients (both point orders) and, for the
    moment transform, the blended moment transfer's gradient."""
    head = JRepPointsHead(num_classes=5, transform_method=method)
    rng = np.random.RandomState(0)
    pts = rng.randn(7, 18).astype(np.float32) * 3
    mt = np.asarray([0.3, -0.2], np.float32)
    w = rng.randn(7, 4).astype(np.float32)
    for y_first in (True, False):
        def jf(p, m):
            box = j_points2bbox(head, p, moment_transfer=m, y_first=y_first)
            return jnp.sum(box * w), box

        (_, want), (jgp, jgm) = jax.jit(jax.value_and_grad(
            jf, argnums=(0, 1), has_aux=True))(jnp.asarray(pts),
                                               jnp.asarray(mt))
        tp = torch.from_numpy(pts).requires_grad_()
        tm = torch.from_numpy(mt).requires_grad_()
        got = points2bbox(head, tp, moment_transfer=tm, y_first=y_first)
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=1e-6, atol=1e-6)
        (got * torch.from_numpy(w)).sum().backward()
        np.testing.assert_allclose(tp.grad.numpy(), np.asarray(jgp),
                                   rtol=1e-5, atol=1e-6)
        if method == "moment":  # moment_mul of the gradient reaches it
            np.testing.assert_allclose(tm.grad.numpy(), np.asarray(jgm),
                                       rtol=1e-5, atol=1e-6)
            assert np.abs(tm.grad.numpy()).max() > 0
        else:  # the min-max transforms do not read it
            assert tm.grad is None and not np.asarray(jgm).any()


def test_focal_and_iou_losses_match_jax():
    rng = np.random.RandomState(1)
    logits = (rng.randn(50, 4) * 3).astype(np.float32)
    labels = rng.randint(0, 5, 50).astype(np.int32)
    weight = (rng.rand(50) > 0.2).astype(np.float32)
    tl = torch.from_numpy(logits).requires_grad_()
    got = sigmoid_focal_loss(tl, torch.from_numpy(labels),
                             weight=torch.from_numpy(weight), avg_factor=7.0)
    want, jg = jax.jit(jax.value_and_grad(lambda x: j_focal(
        x, jnp.asarray(labels), weight=jnp.asarray(weight),
        avg_factor=7.0)))(jnp.asarray(logits))
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6)
    np.testing.assert_allclose(tl.grad.numpy(), np.asarray(jg), rtol=1e-5,
                               atol=1e-7)

    xy = rng.rand(40, 2).astype(np.float32) * 50
    pred = np.concatenate([xy, xy + rng.rand(40, 2) * 30], 1).astype(
        np.float32)
    target = pred + rng.randn(40, 4).astype(np.float32) * 6
    target[:5] = pred[:5] + 100  # no overlap: the eps clip
    w = rng.rand(40).astype(np.float32)
    tp = torch.from_numpy(pred).requires_grad_()
    got = iou_loss(tp, torch.from_numpy(target), weight=torch.from_numpy(w),
                   avg_factor=torch.tensor(3.0))
    want, jg = jax.jit(jax.value_and_grad(lambda p: j_iou_loss(
        p, jnp.asarray(target), weight=jnp.asarray(w), avg_factor=3.0)))(
            jnp.asarray(pred))
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6)
    np.testing.assert_allclose(tp.grad.numpy(), np.asarray(jg), rtol=1e-5,
                               atol=1e-7)


def _points(sizes, strides):
    pts = []
    for (h, w), s in zip(sizes, strides):
        ys, xs = np.mgrid[0:h, 0:w]
        pts.append(np.stack([xs.ravel() * s, ys.ravel() * s,
                             np.full(h * w, s)], 1))
    return np.concatenate(pts).astype(np.float32)


@pytest.mark.parametrize("pos_num", [1, 2, 3])
def test_point_assign_ties_and_invalid_match_jax(pos_num):
    """Gts centred between grid points (2 or 4 points at one distance), one
    repeated (the later claims the points), one invalid that would claim
    the same points, a zero-size invalid one, one on a coarser level; the
    same assignment, labels and distances as vps_tpu's."""
    pts = _points([(16, 16), (8, 8), (4, 4)], (8, 16, 32))
    gts = np.asarray([
        [12, 12, 44, 44],    # centre (28, 28): 4 stride-8 points tie
        [60, 16, 92, 48],    # centre (76, 32): 2 tie in x, then 4
        [12, 12, 44, 44],    # the first repeated: it takes the points
        [12, 12, 44, 44],    # invalid: would tie with both
        [0, 0, 0, 0],        # invalid, zero size
        [40, 40, 104, 104],  # 64 wide: 4 tie on the stride-16 level
    ], np.float32)
    valid = np.asarray([1, 1, 1, 0, 0, 1], bool)
    labels = np.asarray([1, 2, 3, 4, 5, 6], np.int32)
    want = jax.jit(lambda p, g, l, v: j_point_assign(
        p, g, scale=4, pos_num=pos_num, gt_labels=l, gt_valid=v))(
            jnp.asarray(pts), jnp.asarray(gts), jnp.asarray(labels),
            jnp.asarray(valid))
    got = point_assign(torch.from_numpy(pts), torch.from_numpy(gts), scale=4,
                       pos_num=pos_num, gt_labels=torch.from_numpy(labels),
                       gt_valid=torch.from_numpy(valid))
    ja = np.asarray(want.assigned_gt_inds)
    np.testing.assert_array_equal(got.assigned_gt_inds.numpy(), ja)
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    np.testing.assert_allclose(got.max_overlaps.numpy(),
                               np.asarray(want.max_overlaps), rtol=1e-6)
    # a tie shares its rank: the 4 (or 2, then 4) nearest are all claimed
    claimed = [int((ja == g + 1).sum()) for g in range(6)]
    assert claimed == [0, 2 if pos_num <= 2 else 6, 4, 0, 0, 4], claimed


def test_point_assign_stays_linear_in_points():
    """RepPoints' full-width point count (22400 over strides 8-128 at
    800x1344) with 16 gts: no op allocates more than 16 bytes a (point,
    gt) pair (the sort's values and indices take 12), far from an (N, N)
    tensor (JAX's (N, N, G) comparison would be 8e9 booleans)."""
    from torch.profiler import ProfilerActivity, profile

    sizes = [(100, 168), (50, 84), (25, 42), (13, 21), (7, 11)]
    pts = torch.from_numpy(_points(sizes, (8, 16, 32, 64, 128)))
    n, g = pts.shape[0], 16
    assert n == 22400
    rng = np.random.RandomState(2)
    xy = rng.rand(g, 2) * np.asarray([1200, 700])
    gts = torch.from_numpy(np.concatenate(
        [xy, xy + 20 + rng.rand(g, 2) * 300], 1).astype(np.float32))
    with profile(activities=[ProfilerActivity.CPU],
                 profile_memory=True) as prof:
        res = point_assign(pts, gts, scale=4, pos_num=1,
                           gt_valid=torch.arange(g) < 12)
    largest = max(e.cpu_memory_usage for e in prof.events())
    assert 0 < largest <= 16 * n * g < n * n, largest
    assert set(res.assigned_gt_inds.unique().tolist()) == set(range(13))


def test_l2norm_near_zero_features_match_jax():
    """SSD's L2Norm where a location's features are near zero: the 1e-10
    inside the square root dominates there (its norm ~1.0e-5 instead of
    ~2e-6 with the 1e-10 outside it), so both stacks must put it in the
    same place; ordinary locations too. Within 1e-6 relative."""
    from vps_tpu.models.ssd_vgg import L2Norm as JL2Norm
    from vps_torch.models.ssd_vgg import L2Norm

    rng = np.random.RandomState(4)
    x = rng.randn(1, 3, 5, 4).astype(np.float32)
    x[0, 1] = 1e-6 * rng.randn(5, 4)  # a row of near-zero feature vectors
    x[0, 2, 0] = 0.0  # and one of zeros
    weight = (20.0 + rng.randn(4)).astype(np.float32)
    jnorm = JL2Norm()
    want = np.asarray(jax.jit(lambda v: jnorm.apply(v, jnp.asarray(x)))(
        {"params": {"weight": jnp.asarray(weight)}}))
    mod = L2Norm(4)
    with torch.no_grad():
        mod.weight.copy_(torch.from_numpy(weight))
        got = mod(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-30)
    assert np.abs(want[0, 1]).max() < 5.0  # the epsilon held these small
