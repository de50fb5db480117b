"""Port parity, guided anchoring's parts against vps_tpu's on the CPU: the
registry and exports, ``approx_max_iou_assign`` through ``assign_from_cfg``
(tests/test_components.py's case, then padded gt, padded locations, labels
and ties), ``masked_conv2d``, ``guided_anchors_single`` with shape deltas
beyond log(1000/16) (the 1e-6 ratio clip), ``ga_loc_targets`` and
``ga_shape_targets`` (pseudo and random sampler, on the same draws) with
overlapping and padded gt. Cheap: each JAX call one small jit.
"""

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import vps_tpu.core.targets as jtargets
import vps_tpu.models.ga_heads as jga
from vps_tpu.core.sampler import _sample_by_priority as j_by_priority
from vps_tpu.ops.masked_conv import masked_conv2d as j_masked_conv2d

import vps_torch.core.sampler as tsampler
import vps_torch.core.targets as ttargets
import vps_torch.models as tmodels
import vps_torch.models.ga_heads as tga
from vps_torch.ops.box import delta2bbox
from vps_torch.ops.masked_conv import masked_conv2d
from vps_torch.registry import HEADS
from ga_parity import GA_KW, GT
from test_torch_port_threads import one_thread  # noqa: F401  (autouse)
from zoo_parity import Draws

SIZES = [(16, 32), (8, 16), (4, 8)]


def _t(a):
    return torch.from_numpy(np.array(a))


def test_ga_heads_registered_and_exported():
    for name in ("GuidedAnchorHead", "GARPNHead", "GARetinaHead"):
        assert name in HEADS, name
        assert getattr(tmodels, name) is HEADS[name]


def _approx_pair(approxs, gt, cfg, **kw):
    want = jax.jit(partial(jtargets.assign_from_cfg, cfg))(
        jnp.asarray(approxs), jnp.asarray(gt),
        **{k: jnp.asarray(v) for k, v in kw.items()})
    got = ttargets.assign_from_cfg(cfg, _t(approxs), _t(gt),
                                   **{k: _t(v) for k, v in kw.items()})
    np.testing.assert_array_equal(got.assigned_gt_inds.numpy(),
                                  np.asarray(want.assigned_gt_inds))
    np.testing.assert_allclose(got.max_overlaps.numpy(),
                               np.asarray(want.max_overlaps), rtol=1e-6)
    if "gt_labels" in kw:
        np.testing.assert_array_equal(got.labels.numpy(),
                                      np.asarray(want.labels))
    return got


def test_approx_max_iou_assign_matches_jax():
    cfg = dict(type="ApproxMaxIoUAssigner", pos_iou_thr=0.5, neg_iou_thr=0.4,
               approxs_per_octave=3)
    gt = np.asarray([[0, 0, 40, 40]], np.float32)
    approxs = np.asarray([[0, 0, 40, 40], [100, 100, 140, 140],
                          [200, 200, 240, 240], [300, 300, 340, 340],
                          [400, 400, 440, 440], [500, 500, 540, 540]],
                         np.float32)
    got = _approx_pair(approxs, gt, cfg)
    assert got.assigned_gt_inds.tolist() == [1, 0]
    # padded gt and locations, labels, a duplicated gt (the later claims)
    rng = np.random.RandomState(4)
    xy = rng.uniform(0, 100, (60 * 9, 2)).astype(np.float32)
    approxs = np.concatenate([xy, xy + rng.uniform(8, 60, (60 * 9, 2))],
                             1).astype(np.float32)
    gt = np.concatenate([GT["gt_bboxes"], GT["gt_bboxes"][1:2]])
    cfg = dict(cfg, approxs_per_octave=9, min_pos_iou=0.3)
    got = _approx_pair(approxs, gt, cfg,
                       gt_labels=np.asarray([2, 3, 1, 0, 4], np.int32),
                       gt_valid=np.asarray([1, 1, 1, 0, 1], bool),
                       bbox_valid=rng.uniform(size=60) > 0.2)
    gi = got.assigned_gt_inds
    assert (gi > 0).sum() > 3 and (gi == 0).sum() > 3 and (gi == -1).any()
    assert (gi == 5).any()  # the duplicate's low-quality claims: the later
    with pytest.raises(NotImplementedError):
        ttargets.assign_from_cfg(cfg, _t(approxs), _t(gt),
                                 gt_pids=torch.zeros(5, dtype=torch.long))
    with pytest.raises(KeyError):
        ttargets.assign_from_cfg(dict(cfg, type="Nope"), _t(approxs), _t(gt))


@pytest.mark.parametrize("k", [1, 3])
def test_masked_conv2d_matches_jax(k):
    rng = np.random.RandomState(k)
    x = rng.randn(2, 9, 11, 6).astype(np.float32)
    mask = rng.uniform(size=(2, 9, 11)) > 0.5
    w = rng.randn(k, k, 6, 5).astype(np.float32) * 0.3
    b = rng.randn(5).astype(np.float32)
    want = np.asarray(j_masked_conv2d(jnp.asarray(x), jnp.asarray(mask),
                                      jnp.asarray(w), jnp.asarray(b),
                                      padding=(k - 1) // 2))
    got = masked_conv2d(_t(x), _t(mask), _t(w.transpose(3, 2, 0, 1)), _t(b),
                        padding=(k - 1) // 2).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert (got[~mask] == 0).all()


def _heads(**kw):
    kw = dict(GA_KW, **kw)
    return jga.GuidedAnchorHead(num_classes=5, **kw), tga.GuidedAnchorHead(
        num_classes=5, **kw, device="cpu")


def test_guided_anchors_single_matches_jax():
    """Shape deltas up to +-15 (past log(1000/16) = 4.1 and past the 1e-6
    clip's 13.8), GA-RPN's anchoring stds, the loc filter on and off."""
    jhead, thead = _heads(anchoring_stds=(0.07, 0.07, 0.14, 0.14))
    (jsq, *_), (tsq, *_) = (m.ga_generators(h)[1] for m, h in
                            ((jga, jhead), (tga, thead)))
    rng = np.random.RandomState(5)
    h, w = SIZES[0]
    shape = rng.uniform(-15, 15, (h, w, 2)).astype(np.float32) / 0.14
    loc = rng.randn(h, w, 1).astype(np.float32)
    squares = np.asarray(jsq.grid_anchors((h, w), 8))
    np.testing.assert_array_equal(tsq.grid_anchors((h, w), 8).numpy(),
                                  squares)
    for use in (False, True):
        want = jax.jit(lambda sq, sp, lp: jga.guided_anchors_single(
            sq, sp, lp, jhead.anchoring_means, jhead.anchoring_stds, 0.5,
            use))(jnp.asarray(squares), jnp.asarray(shape), jnp.asarray(loc))
        got = tga.guided_anchors_single(
            _t(squares), _t(shape), _t(loc), thead.anchoring_means,
            thead.anchoring_stds, 0.5, use)
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                                   rtol=1e-5, atol=1e-3)
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        assert got[1].all() != use
    # the default clip would have cut these shapes
    sp = _t(shape).reshape(-1, 2)
    default = delta2bbox(_t(squares), torch.cat([torch.zeros_like(sp), sp],
                                                 -1),
                         means=thead.anchoring_means,
                         stds=thead.anchoring_stds)
    assert not torch.allclose(default, got[0], rtol=1e-3)


def _gt():
    """ga_parity's GT (two overlapping, one padded) and a small box on the
    first level overlapping the first: its regions meet the big one's."""
    b = np.concatenate([GT["gt_bboxes"], [[20, 16, 52, 40]]]).astype(
        np.float32)
    return b, np.concatenate([GT["gt_valid"], [True]])


def test_ga_loc_targets_match_jax():
    b, v = _gt()
    for kw in (dict(), dict(center_ratio=0.3, ignore_ratio=0.6)):
        want, wavg = jax.jit(lambda b_, v_: jga.ga_loc_targets(
            b_, v_, SIZES, 4, [8, 16, 32], **kw))(jnp.asarray(b),
                                                  jnp.asarray(v))
        got, gavg = tga.ga_loc_targets(_t(b), _t(v), SIZES, 4, [8, 16, 32],
                                       **kw)
        assert gavg == pytest.approx(float(wavg))
        for (wt, ww), (gt, gw) in zip(want, got):
            np.testing.assert_array_equal(gt.numpy(), np.asarray(wt))
            np.testing.assert_array_equal(gw.numpy(), np.asarray(ww))
    # centres on two levels, ignore regions around them
    assert sum(int(t.sum()) > 0 for t, _ in got) >= 2
    assert any(((w == 0) & (t == 0)).any() for t, w in got)


@pytest.mark.parametrize("sampler", [None, dict(num=64, pos_fraction=0.5)])
def test_ga_shape_targets_match_jax(sampler, monkeypatch):
    jhead, thead = _heads()
    b, v = _gt()
    (jap, jsq), (tap, tsq) = (m.ga_generators(h) for m, h in
                              ((jga, jhead), (tga, thead)))
    approxs = np.concatenate([np.asarray(g.grid_anchors(s, st)) for g, s, st
                              in zip(jap, SIZES, (8, 16, 32))])
    squares = np.concatenate([np.asarray(g.grid_anchors(s, st)) for g, s, st
                              in zip(jsq, SIZES, (8, 16, 32))])
    jdraws, tdraws = Draws(1), Draws(1)

    def j_random_sample(key, gi, num, pos_fraction):
        r = jdraws(gi.shape[0])
        return j_by_priority(jnp.asarray(r[0]), jnp.asarray(r[1]), gi > 0,
                             gi == 0, num, int(num * pos_fraction))

    monkeypatch.setattr(jga, "random_sample", j_random_sample)
    monkeypatch.setattr(tsampler, "uniform", lambda gen, shape, device:
                        torch.from_numpy(tdraws(shape[1])))
    assigner = dict(pos_iou_thr=0.5, neg_iou_thr=0.3, min_pos_iou=0.3)
    want = jax.jit(lambda *a: jga.ga_shape_targets(
        None, *a, assigner, 9, sampler=sampler))(
            jnp.asarray(approxs), jnp.asarray(squares), jnp.asarray(b),
            jnp.asarray(v))
    got = tga.ga_shape_targets(None, _t(approxs), _t(squares), _t(b), _t(v),
                               assigner, 9, sampler=sampler)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert float(got[2]) >= 3
