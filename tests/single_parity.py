"""Shared pieces of the single-stage detectors' parity tests
(``tests/test_torch_port_single_*.py``): the tiny configs (an R-18 trunk
with ResNet ``out_indices=(1, 2, 3)`` and a 32-wide FPN of five levels from
stride 8, on tests/test_two_stage.py's 64x64 image; SSD300's fixed-width
VGG on a seeded 300x300 image), seeded JAX variables (``jax.eval_shape``
of ``init``, filled by ``zoo_parity.fill``; no ``init`` is run), the port
built through ``build_detector`` on the CPU and loaded through
``state_dict_from_jax`` with ``strict=True``.

``pair`` runs both stacks' ``predict`` (JAX jitted); the bar is
``zoo_parity.assert_dets_match``'s. ``train_pair`` runs both stacks'
``loss`` with one jitted value_and_grad on the JAX side and one backward on
the port's, and records each assignment both stacks make (the MaxIoU and
point assigners' ``assigned_gt_inds``, FCOS's target labels, SSD's kept
hard negatives) in call order, so that ``zoo_parity.assert_train_match``
holds them equal slot for slot.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import vps_tpu.core.assigner as jassigner
import vps_tpu.models.anchor_heads as janchor_heads
import vps_tpu.models.detectors.single_stage as jsingle
import vps_tpu.models.reppoints as jreppoints
from vps_tpu.models import build_detector as _jax_registers  # noqa: F401
from vps_tpu.registry import DETECTORS as JDETECTORS

from test_two_stage import IMG, gt
from zoo_parity import fill

import vps_torch.models.anchor_heads as tanchor_heads
import vps_torch.models.detectors.single_stage as tsingle
import vps_torch.models.reppoints as treppoints
from vps_torch.convert import state_dict_from_jax
from vps_torch.models.detectors import build_detector

TRUNK = dict(
    backbone=dict(type="ResNet", depth=18, frozen_stages=-1,
                  out_indices=(1, 2, 3)),
    neck=dict(type="FPN", in_channels=(128, 256, 512), out_channels=32,
              num_outs=5))
# the tiny heads: 5 classes (4 foreground), one conv a tower; FCOS's towers
# are 64 wide so that GroupNorm(32) has two channels a group on the 1x1
# levels (torch refuses a group of one value); RepPoints has
# tests/test_ga_reppoints.py's TestRepPoints widths
CFGS = {
    "RetinaNet": dict(TRUNK, bbox_head=dict(
        type="RetinaHead", num_classes=5, in_channels=32, feat_channels=32,
        stacked_convs=1)),
    "FCOS": dict(TRUNK, bbox_head=dict(
        type="FCOSHead", num_classes=5, in_channels=32, feat_channels=64,
        stacked_convs=1)),
    "RepPointsDetector": dict(TRUNK, bbox_head=dict(
        type="RepPointsHead", num_classes=5, in_channels=32, feat_channels=32,
        point_feat_channels=32, stacked_convs=1)),
    "SSD": dict(backbone=dict(type="SSDVGG", input_size=300),
                bbox_head=dict(type="SSDHead", num_classes=5,
                               input_size=300)),
}
TEST_CFG = dict(nms_pre=40, score_thr=0.05, nms=dict(type="nms", iou_thr=0.5),
                max_per_img=20)
SSD_TEST_CFG = dict(score_thr=0.02, nms=dict(type="nms", iou_thr=0.45),
                    max_per_img=50)
SSD_IMG = np.random.RandomState(3).randn(1, 300, 300, 3).astype(np.float32)


def image(kind):
    return SSD_IMG if kind == "SSD" else np.asarray(IMG)


def _variables(jdet, img, method, seed, **kw):
    shapes = jax.eval_shape(lambda: jdet.init(jax.random.PRNGKey(0), img,
                                              method=method, **kw))
    rng = np.random.default_rng(seed)
    return {k: fill(v, rng) for k, v in shapes.items()}


def _port(kind, params, stats, **cfgs):
    port = build_detector(dict(CFGS[kind], type=kind), device="cpu", **cfgs)
    port.load_state_dict(state_dict_from_jax(params, stats), strict=True)
    return port


def pair(kind, seed=0):
    """vps_tpu's and the port's ``predict`` on the same seeded weights and
    image. Returns (JAX outputs, the port's, as numpy dicts, the port)."""
    test_cfg = SSD_TEST_CFG if kind == "SSD" else TEST_CFG
    img = jnp.asarray(image(kind))
    jdet = JDETECTORS.get(kind)(test_cfg=test_cfg, **CFGS[kind])
    variables = _variables(jdet, img, jdet.predict, seed)
    dets, labels, valid = jax.jit(
        lambda v: jdet.apply(v, img, method=jdet.predict))(variables)
    want = {"det_bboxes": np.asarray(dets), "det_labels": np.asarray(labels),
            "det_valid": np.asarray(valid)}
    port = _port(kind, variables["params"], variables.get("batch_stats"),
                 test_cfg=test_cfg)
    got = port.predict(torch.from_numpy(np.array(image(kind))))
    return want, {k: v.numpy() for k, v in got.items()}, port


def assert_dispatch_matches(kind, port, got):
    """The ``SingleStageDetector`` type builds ``kind`` from its head's type;
    on ``port``'s weights it predicts exactly ``got``."""
    cfg = dict(CFGS[kind], type="SingleStageDetector")
    det = build_detector(cfg, test_cfg=port.test_cfg, device="cpu")
    assert type(det) is type(port)
    det.load_state_dict(port.state_dict(), strict=True)
    out = det.predict(torch.from_numpy(np.array(image(kind))))
    for k, v in out.items():
        np.testing.assert_array_equal(v.numpy(), got[k])


def gt_sample(kind):
    """tests/test_two_stage.py's gt (3 valid boxes of 4 on 64x64); for SSD
    the same layout scaled to 300x300."""
    b, labels, valid, _ = (np.asarray(a) for a in gt())
    if kind == "SSD":
        b = b * np.float32(300 / 64)
    return dict(gt_bboxes=b.astype(np.float32), gt_labels=labels,
                gt_valid=valid)


class _Recorder:
    """Wraps a module attribute so that each call's result is recorded (on
    the JAX side through ``jax.debug.callback``); ``pick`` maps the result
    to the array that is kept."""

    def __init__(self, mp, module, name, pick, out, jax_side):
        fn = getattr(module, name)

        def wrapped(*a, **k):
            res = fn(*a, **k)
            val = pick(res)
            slot = len(out)
            out.append(None)
            if jax_side:
                def record(v):
                    out[slot] = np.asarray(v)

                jax.debug.callback(record, val)
            else:
                out[slot] = val.detach().cpu().numpy()
            return res

        mp.setattr(module, name, wrapped)


def _assigned(res):
    return res.assigned_gt_inds


class _JNumpy:
    """jax.numpy with ``argsort`` recorded (SSD's hard-negative ranking)."""

    def __init__(self, out):
        self._out = out

    def __getattr__(self, name):
        return getattr(jnp, name)

    def argsort(self, a, *args, **kw):
        order = jnp.argsort(a, *args, **kw)
        slot = len(self._out)
        self._out.append(None)

        def record(v):
            self._out[slot] = np.asarray(v)

        jax.debug.callback(record, order)
        return order


def _jax_records(mp, kind, out, orders):
    if kind == "RetinaNet":
        _Recorder(mp, jsingle, "max_iou_assign", _assigned, out, True)
    elif kind == "RepPointsDetector":
        _Recorder(mp, jreppoints, "point_assign", _assigned, out, True)
        _Recorder(mp, jreppoints, "max_iou_assign", _assigned, out, True)
    elif kind == "FCOS":
        _Recorder(mp, janchor_heads, "fcos_target", lambda r: r[0], out, True)
    else:  # ssd_loss imports max_iou_assign when it runs
        _Recorder(mp, jassigner, "max_iou_assign", _assigned, out, True)
        mp.setattr(janchor_heads, "jnp", _JNumpy(orders))


def _port_records(mp, kind, out):
    if kind == "RetinaNet":
        _Recorder(mp, tsingle, "max_iou_assign", _assigned, out, False)
    elif kind == "RepPointsDetector":
        _Recorder(mp, treppoints, "point_assign", _assigned, out, False)
        _Recorder(mp, treppoints, "max_iou_assign", _assigned, out, False)
    elif kind == "FCOS":
        _Recorder(mp, tanchor_heads, "fcos_target", lambda r: r[0], out,
                  False)
    else:
        _Recorder(mp, tanchor_heads, "max_iou_assign", _assigned, out, False)
        _Recorder(mp, tanchor_heads, "hard_negatives", lambda r: r, out,
                  False)


def _ssd_kept(assigned, order, ratio=3):
    """JAX's kept negatives from its assignment and argsort, by its
    formula: rank < ratio x num_pos among the negatives."""
    rank = np.empty_like(order)
    rank[order] = np.arange(order.shape[0])
    return (assigned == 0) & (rank < ratio * float((assigned > 0).sum()))


def train_pair(kind, train_cfg=None, seed=0):
    """vps_tpu's and the port's ``loss`` on the same seeded weights, image
    and gt (``gt_sample``). Returns zoo_parity.train_pair's dict: ``jl`` /
    ``tl`` the terms, ``jg`` / ``tg`` the gradients by the port's names,
    ``jsel`` / ``tsel`` each assignment (its array, all slots valid) in
    call order, and ``port``."""
    sample = gt_sample(kind)
    img = image(kind)
    jargs = {k: jnp.asarray(v) for k, v in sample.items()}
    jdet = JDETECTORS.get(kind)(train_cfg=train_cfg, **CFGS[kind])
    variables = _variables(jdet, jnp.asarray(img), jdet.loss, seed, **jargs)
    params = variables["params"]
    stats = variables.get("batch_stats")
    jsel, orders = [], []
    with pytest.MonkeyPatch.context() as mp:
        _jax_records(mp, kind, jsel, orders)

        def f(p):
            v = {"params": p}
            if stats is not None:
                v["batch_stats"] = stats
            losses = jdet.apply(v, jnp.asarray(img), **jargs,
                                method=jdet.loss)
            return sum(losses.values()), losses

        (_, jl), jg = jax.jit(jax.value_and_grad(f, has_aux=True))(params)
        jl = {k: float(v) for k, v in jl.items()}
    if kind == "SSD":
        (order,) = orders
        jsel.append(_ssd_kept(jsel[0], order))

    port = _port(kind, params, stats, train_cfg=train_cfg)
    tsel = []
    with pytest.MonkeyPatch.context() as mp:
        _port_records(mp, kind, tsel)
        losses = port.loss(torch.from_numpy(np.array(img)),
                           **{k: torch.from_numpy(np.array(v))
                              for k, v in sample.items()})
        sum(losses.values()).backward()

    def slots(sel):
        return [(a.astype(np.int64), np.ones(a.shape, bool)) for a in sel]

    return dict(jl=jl, tl={k: float(v.detach()) for k, v in losses.items()},
                jg={k: v.numpy() for k, v in state_dict_from_jax(
                    jax.tree.map(np.asarray, jg)).items()},
                tg={n: None if p.grad is None else p.grad.numpy()
                    for n, p in port.named_parameters()},
                jsel=slots(jsel), tsel=slots(tsel), port=port)


# the train_cfg each detector reads: mmdetection v1.0's values
TRAIN_CFGS = {
    "RetinaNet": dict(pos_iou_thr=0.5, neg_iou_thr=0.4, min_pos_iou=0.0),
    "FCOS": None,
    "RepPointsDetector": dict(
        init=dict(scale=4, pos_num=1),
        refine=dict(assigner=dict(pos_iou_thr=0.5, neg_iou_thr=0.4,
                                  min_pos_iou=0.0))),
    "SSD": dict(assigner=dict(pos_iou_thr=0.5, neg_iou_thr=0.5),
                smoothl1_beta=1.0, neg_pos_ratio=3),
}
# every loss term within this relative error of JAX's: no sampled selection
# (the assignments are held equal), f32 sums in other orders
SINGLE_REL = 1e-4


def float64_grads(r, kind, train_cfg=None):
    """The gradients of the port's total loss with ``r["port"]``'s weights
    run in float64 on the same image and gt, by parameter name."""
    import copy

    port = copy.deepcopy(r["port"]).double()
    port.zero_grad(set_to_none=True)
    sample = gt_sample(kind)
    losses = port.loss(torch.from_numpy(image(kind)).double(),
                       torch.from_numpy(sample["gt_bboxes"]).double(),
                       torch.from_numpy(sample["gt_labels"]),
                       torch.from_numpy(sample["gt_valid"]))
    sum(losses.values()).backward()
    return {n: None if p.grad is None else p.grad.float().numpy()
            for n, p in port.named_parameters()}
