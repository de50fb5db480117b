"""Port parity, the training ops: vps_torch's losses, box coding, mask
targets, assigner, sampler, targets, track loss, correlation gradients, LR
schedule and optimizer held against vps_tpu's on the same numpy inputs.

Sampler draws: both sides take the same seeded numpy priorities, the port's
through ``vps_torch.core.sampler.uniform`` and JAX's through
``random_sample`` where ``vps_tpu.core.targets`` looks it up (patched in the
test; no file of vps_tpu changes). The trainable set is checked in a
one-test file of its own, ``test_torch_port_trainable.py`` (pytest-xdist's
loadfile scheduler queues a one-test file after the files with several).
"""

import functools

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import optax
import torch

import vps_tpu.core.targets as jtargets
from vps_tpu.core.assigner import max_iou_assign as j_max_iou_assign
from vps_tpu.core.sampler import _sample_by_priority as j_sample_by_priority
from vps_tpu.models.track_head import track_match_loss as j_track_match_loss
from vps_tpu.ops import box as jbox
from vps_tpu.ops import losses as jlosses
from vps_tpu.ops.correlation import _correlation_xla
from vps_tpu.ops.mask import crop_and_resize_indexed as j_crop
from vps_tpu.ops.roi_align import multilevel_roi_align as j_roi_align
from vps_tpu.train import optim as joptim

from test_torch_port_threads import one_thread  # noqa: F401  (autouse)

import vps_torch.core.sampler as tsampler
from vps_torch import zoo
from vps_torch.core.assigner import max_iou_assign
from vps_torch.core.sampler import _sample_by_priority
from vps_torch.core.targets import anchor_target, proposal_target
from vps_torch.models.track_head import track_match_loss
from vps_torch.ops import box as tbox
from vps_torch.ops import losses as tlosses
from vps_torch.ops.correlation import correlation
from vps_torch.ops.mask import crop_and_resize_indexed
from vps_torch.ops.roi_align import multilevel_roi_align
from vps_torch.train.optim import (
    build_lr_schedule,
    build_optimizer,
)
from vps_torch.utils.checkpoint import load_checkpoint, save_checkpoint

T = torch.from_numpy


def _np(x):
    return np.asarray(x.detach().numpy() if torch.is_tensor(x) else x)


def _close(a, b, rtol=1e-5, atol=1e-6, err_msg=""):
    np.testing.assert_allclose(_np(a), np.asarray(b), rtol=rtol, atol=atol,
                               err_msg=err_msg)


def _boxes(rng, n, h=64, w=128):
    xy = rng.uniform(0, [w - 8, h - 8], (n, 2))
    wh = rng.uniform(4, [w / 2, h / 2], (n, 2))
    return np.concatenate([xy, np.minimum(xy + wh, [w - 1, h - 1])],
                          1).astype(np.float32)


def prios(n):
    """The shared sampler priorities of an n-candidate draw: (2, n)."""
    return np.random.RandomState(n).rand(2, n).astype(np.float32)


@pytest.fixture
def same_draws(monkeypatch):
    """Both samplers take ``prios``: the port's ``uniform`` and JAX's
    ``random_sample`` as ``vps_tpu.core.targets`` calls it."""
    monkeypatch.setattr(tsampler, "uniform",
                        lambda gen, shape, device: T(prios(shape[1])))

    def j_random_sample(key, gi, num, pos_fraction):
        r = prios(gi.shape[0])
        return j_sample_by_priority(jnp.asarray(r[0]), jnp.asarray(r[1]),
                                    gi > 0, gi == 0, num,
                                    int(num * pos_fraction))

    monkeypatch.setattr(jtargets, "random_sample", j_random_sample)


# --------------------------------------------------------------- losses


@pytest.mark.parametrize("weighted", [False, True])
def test_smooth_l1_and_bce(weighted):
    rng = np.random.RandomState(0)
    pred, tgt = rng.randn(2, 50, 4).astype(np.float32)
    w = (rng.rand(50, 4) > 0.3).astype(np.float32) if weighted else None
    avg = 17.0 if weighted else None
    tw = None if w is None else T(w)
    _close(tlosses.smooth_l1_loss(T(pred), T(tgt), 1 / 9, tw, avg),
           jlosses.smooth_l1_loss(pred, tgt, 1 / 9, w, avg))
    t01 = (tgt > 0).astype(np.float32)
    _close(tlosses.binary_cross_entropy_with_logits(T(pred * 4), T(t01), tw,
                                                    avg),
           jlosses.binary_cross_entropy_with_logits(pred * 4, t01, w, avg))


@pytest.mark.parametrize("mode", ["ignore", "weight_avg"])
def test_softmax_cross_entropy_and_accuracy(mode):
    rng = np.random.RandomState(1)
    logits = (rng.randn(6, 7, 19) * 3).astype(np.float32)
    labels = rng.randint(0, 19, (6, 7)).astype(np.int32)
    labels[rng.rand(6, 7) < 0.3] = 255
    if mode == "ignore":
        kw = dict(ignore_index=255)
        tkw = kw
    else:
        labels = np.clip(labels, 0, 18)
        w = rng.rand(6, 7).astype(np.float32)
        kw = dict(weight=w, avg_factor=np.float32(9.5))
        tkw = dict(weight=T(w), avg_factor=9.5)
    _close(tlosses.softmax_cross_entropy(T(logits), T(labels), **tkw),
           jlosses.softmax_cross_entropy(logits, labels, **kw))
    valid = rng.rand(6, 7) > 0.5
    _close(tlosses.accuracy(T(logits), T(labels).long(), T(valid)),
           jlosses.accuracy(logits, labels, valid))


def test_track_match_loss():
    rng = np.random.RandomState(2)
    logits = (rng.randn(20, 6) * 2).astype(np.float32)
    ids = rng.randint(0, 6, 20).astype(np.int32)
    w = (rng.rand(20) > 0.4).astype(np.float32)
    ours = track_match_loss(T(logits), T(ids), T(w))
    ref = j_track_match_loss(logits, ids, w)
    for a, b in zip(ours, ref):
        _close(a, b)


# --------------------------------------------------- boxes, masks, assign


def test_bbox2delta_and_legacy_overlaps():
    """bbox2delta with the bbox head's stds; bbox_overlaps keeps offset=1
    (legacy +1 widths), touching and degenerate boxes included."""
    rng = np.random.RandomState(3)
    a, b = _boxes(rng, 30), _boxes(rng, 30)
    stds = (0.1, 0.1, 0.2, 0.2)
    _close(tbox.bbox2delta(T(a), T(b), (0.0,) * 4, stds),
           jbox.bbox2delta(a, b, (0.0,) * 4, stds))
    a[:3] = [[0, 0, 0, 0], [5, 5, 5, 9], [10, 10, 20, 20]]
    b[:3] = [[0, 0, 0, 0], [6, 5, 9, 9], [21, 10, 30, 20]]
    _close(tbox.bbox_overlaps(T(a), T(b)), jbox.bbox_overlaps(a, b, offset=1.0))


def test_crop_and_resize_indexed():
    rng = np.random.RandomState(4)
    masks = (rng.rand(5, 40, 60) > 0.5).astype(np.float32)
    boxes = _boxes(rng, 12, 40, 60)
    boxes[0] = [-5, -3, 70, 50]  # past the border: clamped samples
    idx = rng.randint(0, 5, 12).astype(np.int32)
    _close(crop_and_resize_indexed(T(masks), T(idx), T(boxes), 28),
           j_crop(masks, idx, boxes, 28))


def test_max_iou_assign():
    """Thresholds, the low-quality step (later gt wins ties), padded gts and
    boxes, labels and pids."""
    rng = np.random.RandomState(5)
    gts = _boxes(rng, 6)
    boxes = np.concatenate([_boxes(rng, 80), gts[:2], gts[:2]], 0)
    gts[4] = gts[3]  # a duplicate gt: the later one claims its boxes
    bvalid = rng.rand(84) > 0.1
    gvalid = np.array([1, 1, 1, 1, 1, 0], bool)
    labels = np.arange(1, 7, dtype=np.int32)
    pids = np.arange(10, 16, dtype=np.int32)
    kw = dict(pos_iou_thr=0.5, neg_iou_thr=0.4, min_pos_iou=0.3)
    ours = max_iou_assign(T(boxes), T(gts), gt_labels=T(labels),
                          gt_pids=T(pids), bbox_valid=T(bvalid),
                          gt_valid=T(gvalid), **kw)
    ref = jax.jit(functools.partial(j_max_iou_assign, **kw))(
        boxes, gts, gt_labels=labels, gt_pids=pids, bbox_valid=bvalid,
        gt_valid=gvalid)
    assert (_np(ours.assigned_gt_inds) > 0).sum() > 5
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(_np(a), np.asarray(b))


def test_sample_by_priority():
    """Positives capped at max_pos and put first, negatives fill, the rest
    invalid; tied priorities resolved as JAX's stable sort does."""
    rng = np.random.RandomState(6)
    gi = rng.choice([-1, 0, 0, 1, 2], 300).astype(np.int32)
    pp = np.round(rng.rand(300), 1).astype(np.float32)  # many ties
    pn = rng.rand(300).astype(np.float32)
    ours = _sample_by_priority(T(pp), T(pn), T(gi > 0), T(gi == 0), 128, 32)
    ref = jax.jit(j_sample_by_priority, static_argnums=(4, 5))(
        pp, pn, gi > 0, gi == 0, 128, 32)
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(_np(a), np.asarray(b))


# ---------------------------------------------------------------- targets


def test_anchor_target(same_draws):
    from vps_torch.ops.anchors import AnchorGenerator

    rng = np.random.RandomState(7)
    anchors = np.concatenate([
        _np(AnchorGenerator(s, [8], [0.5, 1.0, 2.0]).grid_anchors(
            (64 // s, 128 // s), s, device="cpu")) for s in (4, 8, 16)])
    gts = _boxes(rng, 4)
    gvalid = np.array([1, 1, 1, 0], bool)
    cfg = zoo.tiny_train_cfg()["rpn"]
    ours = anchor_target(None, T(anchors), torch.ones(len(anchors), dtype=bool),
                         T(gts), T(gvalid), (64, 128), cfg)
    ref = jax.jit(lambda *a: jtargets.anchor_target(
        jax.random.PRNGKey(0), *a, (64, 128), cfg))(
            anchors, np.ones(len(anchors), bool), gts, gvalid)
    assert int(ours.num_pos) > 0
    for a, b in zip(ours, ref):
        _close(a, b)


def test_proposal_target(same_draws):
    """add_gt_as_proposals, the pid -> id targets and the 28x28 mask targets
    of the positive prefix."""
    rng = np.random.RandomState(8)
    gts = _boxes(rng, 5)
    gvalid = np.array([1, 1, 1, 1, 0], bool)
    labels = np.array([1, 4, 2, 8, 0], np.int32)
    pids = np.array([3, 0, 1, 2, 0], np.int32)
    props = np.concatenate([_boxes(rng, 100),
                            gts[:4] + rng.randn(4, 4).astype(np.float32)])
    pvalid = rng.rand(104) > 0.05
    masks = (rng.rand(5, 64, 128) > 0.6).astype(np.float32)
    cfg = zoo.tiny_train_cfg()["rcnn"]
    ours = proposal_target(None, T(props), T(pvalid), T(gts), T(labels),
                           T(gvalid), cfg, gt_pids=T(pids), gt_masks=T(masks))
    ref = jax.jit(lambda *a: jtargets.proposal_target(
        jax.random.PRNGKey(0), *a[:5], cfg, gt_pids=a[5], gt_masks=a[6]))(
            props, pvalid, gts, labels, gvalid, pids, masks)
    assert int(ours.num_pos) >= 4 and int(ours.ids.gt(0).sum()) > 0
    for name, a, b in zip(ours._fields, ours, ref):
        _close(a, b, rtol=1e-5, atol=1e-5, err_msg=name)


# ------------------------------------------------------ correlation grads


@pytest.mark.parametrize("geom", ["liteflow", "flownetc"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_correlation_gradients_match_jax(geom, dtype):
    """Autograd through the port's plain correlation (its CPU path) against
    jax.vjp of _correlation_xla, small forms of both call sites.
    f32: rel 1e-5 of the gradient's max. bf16: JAX rounds each of the D^2
    products and each partial sum of the cotangent to bf16 (up to 441 of
    them at FlowNetC) where the port sums in f32 and rounds once, so the
    bound is 16 bf16 ulps of the max (2^-4 relative; measured up to 7.2)."""
    md, s2, shape = {"liteflow": (4, 1, (1, 12, 20, 32)),
                     "flownetc": (20, 2, (1, 12, 24, 16))}[geom]
    rng = np.random.RandomState(9)
    f1, f2 = rng.randn(2, *shape).astype(np.float32)
    d2 = (2 * (md // s2) + 1) ** 2
    g = rng.randn(*shape[:3], d2).astype(np.float32)
    jdt = jnp.dtype(dtype)
    tdt = getattr(torch, dtype)
    ref = jax.jit(lambda a, b, ct: jax.vjp(
        lambda a, b: _correlation_xla(a, b, md, s2), a, b)[1](ct))(
            jnp.asarray(f1, jdt), jnp.asarray(f2, jdt), jnp.asarray(g, jdt))
    a = T(f1).to(tdt).requires_grad_(True)
    b = T(f2).to(tdt).requires_grad_(True)
    out = correlation(a, b, md, s2)
    out.backward(T(g).to(tdt))
    rel = 1e-5 if dtype == "float32" else 16 * 2.0 ** -8
    for ours, theirs in zip((a.grad, b.grad), ref):
        assert ours.dtype == tdt
        theirs = np.asarray(theirs, np.float32)
        err = np.abs(ours.float().numpy() - theirs).max()
        assert err <= rel * np.abs(theirs).max(), (err, np.abs(theirs).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_roi_align_backward_matches_jax(dtype):
    """The features' gradient of multilevel RoIAlign against jax.vjp of
    vps_tpu's (its custom VJP, _mra_cvjp_bwd): a scatter-add of the corner
    weights accumulated in f32, cast to the feature dtype. f32: rel 1e-5 of
    the max; bf16: one bf16 ulp of the max (both round one f32 sum)."""
    rng = np.random.RandomState(11)
    shapes = [(16, 24), (8, 12), (4, 6), (2, 3)]
    feats = [rng.randn(h, w, 8).astype(np.float32) for h, w in shapes]
    rois = np.concatenate([_boxes(rng, 10, 64, 96), [[-10, -5, 30, 20],
                                                     [0, 0, 95, 63]]])
    rois = rois.astype(np.float32)
    valid = np.arange(12) != 3
    ct = rng.randn(12, 7, 7, 8).astype(np.float32)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    ref = jax.jit(lambda fs, g: jax.vjp(
        lambda *f: j_roi_align(list(f), rois, [4, 8, 16, 32], 7, 2,
                               valid=valid), *fs)[1](g))(
        [jnp.asarray(f, jdt) for f in feats], jnp.asarray(ct))
    ts = [T(f).to(tdt).requires_grad_(True) for f in feats]
    out = multilevel_roi_align(ts, T(rois), [4, 8, 16, 32], 7, 2,
                               valid=T(valid))
    out.backward(T(ct))
    rel = 1e-5 if dtype == "float32" else 2.0 ** -7
    for t, r in zip(ts, ref):
        r = np.asarray(r, np.float32)
        assert t.grad.dtype == tdt
        err = np.abs(t.grad.float().numpy() - r).max()
        assert err <= rel * np.abs(r).max(), err


# ------------------------------------------------------ schedule, optimizer


def test_lr_schedule_matches_jax():
    spe = 100
    ours = build_lr_schedule(0.005, spe, 12)
    ref = joptim.build_lr_schedule(0.005, spe, 12)
    steps = [0, 1, 250, 499, 500, 501, 8 * spe - 1, 8 * spe, 11 * spe - 1,
             11 * spe, 12 * spe]
    for s in steps:
        np.testing.assert_allclose(float(ours(s)), float(ref(s)), rtol=1e-6,
                                   err_msg=f"step {s}")
    assert float(ours(0)) == pytest.approx(0.005 / 3, rel=1e-6)
    assert float(ours(11 * spe)) == pytest.approx(0.005 * 0.01, rel=1e-5)


class _Tree(torch.nn.Module):
    """Parameters named like the detector's: a frozen stem, a trained stage
    and a head."""

    def __init__(self, rng):
        super().__init__()
        self.backbone = torch.nn.Module()
        self.backbone.conv1 = torch.nn.Linear(4, 3)
        self.backbone.layer2 = torch.nn.Linear(3, 5)
        self.head = torch.nn.Linear(5, 2)
        with torch.no_grad():
            for p in self.parameters():
                p.copy_(T(rng.randn(*p.shape).astype(np.float32)))


def _jax_tree(module):
    """The same values as a flax-style tree (frozen paths as JAX names)."""
    names = {"backbone.conv1": ("backbone", "conv1"),
             "backbone.layer2": ("backbone", "layer2_0"),
             "head": ("head",)}
    tree = {}
    for name, p in module.named_parameters():
        mod, leaf = name.rsplit(".", 1)
        node = tree
        for k in names[mod]:
            node = node.setdefault(k, {})
        node[leaf] = jnp.asarray(_np(p).copy())  # no view of the torch memory
    return tree, names


def test_optimizer_matches_optax_chain():
    """3 steps (the second with a NaN gradient, the third clipped) against
    optax's apply_if_finite(masked(chain(clip, decay, sgd))): equal
    parameters after each step, and an equal skip count."""
    rng = np.random.RandomState(10)
    mod = _Tree(rng)
    jparams, names = _jax_tree(mod)
    mod.backbone.conv1.requires_grad_(False)  # the stem of frozen_stages=1
    sched = build_lr_schedule(0.01, 5, 12, warmup_iters=3)
    opt, mask = build_optimizer(mod, sched)
    assert mask == {"backbone.conv1.weight": False, "backbone.conv1.bias": False,
                    "backbone.layer2.weight": True, "backbone.layer2.bias": True,
                    "head.weight": True, "head.bias": True}
    tx, _ = joptim.build_optimizer(
        jparams, joptim.build_lr_schedule(0.01, 5, 12, warmup_iters=3),
        frozen_stages=1)
    jstate = tx.init(jparams)
    update = jax.jit(tx.update)
    for step, scale in enumerate((1.0, float("nan"), 100.0)):
        grads = {n: rng.randn(*p.shape).astype(np.float32) * scale
                 for n, p in mod.named_parameters() if p.requires_grad}
        jgrads = jax.tree.map(jnp.zeros_like, jparams)
        for n, p in mod.named_parameters():
            if n in grads:
                p.grad = T(grads[n])
                mname, leaf = n.rsplit(".", 1)
                node = jgrads
                for k in names[mname]:
                    node = node[k]
                node[leaf] = jnp.asarray(grads[n].copy())
        applied = opt.step()
        assert applied == (step != 1)
        updates, jstate = update(jgrads, jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        back, _ = _jax_tree(mod)
        jax.tree.map(lambda a, b: np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), rtol=1e-6, atol=1e-7), back, jparams)
        assert opt.total_notfinite == int(jstate.total_notfinite)
    assert opt.total_notfinite == 1 and opt.count == 2


def test_checkpoint_refuses_another_model(tmp_path):
    """A weights-only checkpoint restores into a training template; a
    checkpoint of another model (other names or shapes) raises."""
    sd = {"backbone.w": torch.ones(3, 3), "head.b": torch.zeros(4)}
    path = save_checkpoint(str(tmp_path), 1, sd, meta=dict(epoch=1))
    out = load_checkpoint(path, {"state_dict": {k: torch.zeros_like(v)
                                                for k, v in sd.items()},
                                 "opt_state": {"count": 0}})
    torch.testing.assert_close(out["state_dict"]["backbone.w"], sd["backbone.w"])
    assert out["opt_state"] == {"count": 0}
    with pytest.raises(ValueError):
        load_checkpoint(path, {"state_dict": {"backbone.w": torch.zeros(3, 3),
                                              "other.x": torch.zeros(4)}})
    with pytest.raises(ValueError):
        load_checkpoint(path, {"state_dict": {"backbone.w": torch.zeros(5, 5),
                                              "head.b": torch.zeros(4)}})
