"""Single-stage detection heads (port of vps_tpu/models/anchor_heads.py):
RetinaHead, SSDHead, FCOSHead with its per-level ``Scale``, and their pure
decode and loss functions: ``anchor_head_bboxes``, ``ssd_anchor_generators``,
``ssd_loss``, ``fcos_points``, ``fcos_target``, ``fcos_loss``,
``fcos_bboxes``.

The heads are NCHW modules with mmdet's state_dict names (``cls_convs.i``,
``retina_cls``, ``fcos_centerness``, ``scales.i.scale``, ...) and return
per-level (B, C, H, W) maps; the functions take one image's per-level maps
channel-last, (H, W, C), the JAX layout, so every flattening order is the
JAX one: location-major, the A anchors of a location contiguous.

Decoding is static shape, as in JAX: per level the ``nms_pre`` best
locations by their best class score (a stable descending sort, so ties keep
index order as ``jax.lax.top_k``), decoded and clipped, then one
``multiclass_nms`` over every level with a zero background column.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from vps_torch.core.assigner import max_iou_assign
from vps_torch.models.layers import Conv, ConvModule
from vps_torch.ops.anchors import AnchorGenerator
from vps_torch.ops.box import bbox2delta, delta2bbox
from vps_torch.ops.losses import (
    binary_cross_entropy_with_logits,
    iou_loss,
    sigmoid_focal_loss,
    smooth_l1_loss,
)
from vps_torch.ops.nms import multiclass_nms, top_k
from vps_torch.registry import HEADS


def _towers(cin, feat, n, device, gn_groups=None):
    return nn.ModuleList(
        ConvModule(cin if i == 0 else feat, feat, 3, 1, 1, device=device,
                   gn_groups=gn_groups) for i in range(n))


@HEADS.register
class RetinaHead(nn.Module):
    """RetinaNet head: ``stacked_convs`` 3x3 conv + ReLU towers for the
    classes and the boxes, shared over the levels; ``retina_cls`` gives
    ``num_anchors`` x (num_classes - 1) sigmoid logits a location,
    ``retina_reg`` ``num_anchors`` x 4 deltas."""

    def __init__(self, num_classes: int = 81, in_channels: int = 256,
                 feat_channels: int = 256, stacked_convs: int = 4,
                 num_anchors: int = 9, device=None):
        super().__init__()
        self.num_classes = num_classes
        self.cls_convs = _towers(in_channels, feat_channels, stacked_convs,
                                 device)
        self.reg_convs = _towers(in_channels, feat_channels, stacked_convs,
                                 device)
        self.retina_cls = Conv(feat_channels, num_anchors * (num_classes - 1),
                               3, 1, 1, device=device)
        self.retina_reg = Conv(feat_channels, num_anchors * 4, 3, 1, 1,
                               device=device)

    def forward(self, feats):
        cls_scores, bbox_preds = [], []
        for f in feats:
            c, r = f, f
            for conv in self.cls_convs:
                c = conv(c)
            for conv in self.reg_convs:
                r = conv(r)
            cls_scores.append(self.retina_cls(c))
            bbox_preds.append(self.retina_reg(r))
        return cls_scores, bbox_preds


@HEADS.register
class SSDHead(nn.Module):
    """SSD head: one 3x3 class conv (``cls_convs.i``, a softmax over
    ``num_classes`` with the background) and one 3x3 box conv
    (``reg_convs.i``) a level, each level with its own channels and anchors."""

    def __init__(self, num_classes: int = 81,
                 in_channels: Sequence[int] = (512, 1024, 512, 256, 256, 256),
                 anchors_per_level: Sequence[int] = (4, 6, 6, 6, 4, 4),
                 device=None):
        super().__init__()
        self.num_classes = num_classes
        self.cls_convs = nn.ModuleList(
            Conv(c, a * num_classes, 3, 1, 1, device=device)
            for c, a in zip(in_channels, anchors_per_level))
        self.reg_convs = nn.ModuleList(
            Conv(c, a * 4, 3, 1, 1, device=device)
            for c, a in zip(in_channels, anchors_per_level))

    def forward(self, feats):
        return ([conv(f) for conv, f in zip(self.cls_convs, feats)],
                [conv(f) for conv, f in zip(self.reg_convs, feats)])


class Scale(nn.Module):
    """A learnable scalar multiplier (FCOS's per-level box scale)."""

    def __init__(self, init: float = 1.0, device=None):
        super().__init__()
        self.scale = nn.Parameter(torch.tensor(float(init), device=device))

    def forward(self, x):
        return x * self.scale


@HEADS.register
class FCOSHead(nn.Module):
    """FCOS head: towers of 3x3 conv (no bias) + GroupNorm(32) + ReLU;
    ``fcos_cls`` (num_classes - 1 sigmoid logits) and ``fcos_centerness``
    read the class tower, ``fcos_reg`` the box tower, whose output is
    exp(scale_l * reg): the l, t, r, b distances of a point."""

    def __init__(self, num_classes: int = 81, in_channels: int = 256,
                 feat_channels: int = 256, stacked_convs: int = 4,
                 num_levels: int = 5, device=None):
        super().__init__()
        self.num_classes = num_classes
        self.cls_convs = _towers(in_channels, feat_channels, stacked_convs,
                                 device, gn_groups=32)
        self.reg_convs = _towers(in_channels, feat_channels, stacked_convs,
                                 device, gn_groups=32)
        self.fcos_cls = Conv(feat_channels, num_classes - 1, 3, 1, 1,
                             device=device)
        self.fcos_reg = Conv(feat_channels, 4, 3, 1, 1, device=device)
        self.fcos_centerness = Conv(feat_channels, 1, 3, 1, 1, device=device)
        self.scales = nn.ModuleList(Scale(device=device)
                                    for _ in range(num_levels))

    def forward(self, feats):
        cls_scores, bbox_preds, centernesses = [], [], []
        for f, scale in zip(feats, self.scales):
            c, r = f, f
            for conv in self.cls_convs:
                c = conv(c)
            for conv in self.reg_convs:
                r = conv(r)
            cls_scores.append(self.fcos_cls(c))
            centernesses.append(self.fcos_centerness(c))
            bbox_preds.append(torch.exp(scale(self.fcos_reg(r))))
        return cls_scores, bbox_preds, centernesses


def padded_multiclass_nms(boxes, scores, score_thr, nms_thr, max_per_img,
                          nms_cfg):
    """multiclass_nms of (N, 4) boxes over (N, C - 1) foreground scores, a
    zero background column padded in front (its 1-based convention)."""
    padded = torch.cat([torch.zeros_like(scores[:, :1]), scores], -1)
    return multiclass_nms(boxes, padded, score_thr=score_thr, iou_thr=nms_thr,
                          max_num=max_per_img, nms_cfg=nms_cfg)


def anchor_head_bboxes(cls_scores, bbox_preds, anchors_per_level, img_shape,
                       num_classes: int, use_sigmoid: bool = True,
                       nms_pre: int = 1000, score_thr: float = 0.05,
                       nms_thr: float = 0.5, max_per_img: int = 100,
                       target_means=(0.0, 0.0, 0.0, 0.0),
                       target_stds=(1.0, 1.0, 1.0, 1.0), nms_cfg=None):
    """One image's anchor-head outputs -> fixed-capacity detections.

    cls_scores / bbox_preds: per-level (H, W, A * C') / (H, W, A * 4), C'
    the foreground classes (sigmoid) or all of them (softmax, the background
    first and dropped). Returns multiclass_nms's (dets (max, 5), labels
    (max,) 0-based, valid (max,))."""
    fg = num_classes - 1
    lvl_boxes, lvl_scores = [], []
    for cls, reg, anchors in zip(cls_scores, bbox_preds, anchors_per_level):
        if use_sigmoid:
            scores = torch.sigmoid(cls.reshape(-1, fg))
        else:
            scores = F.softmax(cls.reshape(-1, num_classes), -1)[:, 1:]
        deltas = reg.reshape(-1, 4)
        k = min(nms_pre, scores.shape[0])
        _, idx = top_k(scores.max(-1).values, k)
        lvl_boxes.append(delta2bbox(anchors[idx], deltas[idx],
                                    max_shape=img_shape, means=target_means,
                                    stds=target_stds))
        lvl_scores.append(scores[idx])
    return padded_multiclass_nms(torch.cat(lvl_boxes), torch.cat(lvl_scores),
                                 score_thr, nms_thr, max_per_img, nms_cfg)


def ssd_anchor_generators(input_size: int = 300, num_levels: int = 6,
                          strides: Sequence[int] = (8, 16, 32, 64, 100, 300),
                          anchor_ratios: Sequence[Sequence[int]] = (
                              [2], [2, 3], [2, 3], [2, 3], [2], [2]),
                          basesize_ratio_range: Tuple[float, float] = (0.15,
                                                                       0.9)):
    """The SSD anchor plan: per-level min and max sizes from the base-size
    ratio range (with SSD300's and SSD512's first-level insertions for COCO
    and VOC), scale-major generators centred at (stride - 1) / 2, and the
    base anchors reordered so the sqrt(max / min) square comes second."""
    min_ratio = int(basesize_ratio_range[0] * 100)
    max_ratio = int(basesize_ratio_range[1] * 100)
    step = int(np.floor(max_ratio - min_ratio) / (num_levels - 2))
    min_sizes, max_sizes = [], []
    for r in range(min_ratio, max_ratio + 1, step):
        min_sizes.append(int(input_size * r / 100))
        max_sizes.append(int(input_size * (r + step) / 100))
    first = {(300, 0.15): (7, 15), (300, 0.2): (10, 20),
             (512, 0.1): (4, 10), (512, 0.15): (7, 15)}.get(
                 (input_size, basesize_ratio_range[0]))
    if first is not None:  # COCO's or VOC's first level
        min_sizes.insert(0, int(input_size * first[0] / 100))
        max_sizes.insert(0, int(input_size * first[1] / 100))
    gens = []
    for k in range(num_levels):
        stride = strides[k]
        ratios = [1.0]
        for r in anchor_ratios[k]:
            ratios += [1.0 / r, r]
        gen = AnchorGenerator(
            min_sizes[k], [1.0, float(np.sqrt(max_sizes[k] / min_sizes[k]))],
            ratios, scale_major=False,
            ctr=((stride - 1) / 2.0, (stride - 1) / 2.0))
        indices = list(range(len(ratios)))
        indices.insert(1, len(indices))  # the big square second
        gen.base_anchors = gen.base_anchors[indices]
        gens.append(gen)
    return gens


def hard_negatives(ce, neg, num_pos, neg_pos_ratio: int):
    """SSD's online hard-negative mining: a negative is kept iff its cross
    entropy ranks among the ``neg_pos_ratio`` x ``num_pos`` highest of the
    negatives (a stable descending sort: ties keep index order, as JAX's
    ``argsort``)."""
    neg_ce = torch.where(neg, ce, torch.full_like(ce, float("-inf")))
    order = torch.argsort(-neg_ce, stable=True)
    rank = torch.empty_like(order).scatter_(
        0, order, torch.arange(order.shape[0], device=order.device))
    return neg & (rank < neg_pos_ratio * num_pos)


def ssd_loss(cls_scores, bbox_preds, anchors_per_level, gt_bboxes, gt_labels,
             gt_valid, num_classes: int, neg_pos_ratio: int = 3,
             smoothl1_beta: float = 1.0, pos_iou_thr: float = 0.5,
             neg_iou_thr: float = 0.5, target_means=(0.0, 0.0, 0.0, 0.0),
             target_stds=(0.1, 0.1, 0.2, 0.2)):
    """SSD's MultiBox loss of one image: MaxIoU without the low-quality step,
    softmax cross entropy over the positives and the hard negatives
    (``hard_negatives``), smooth L1 of the positives' coded deltas; both over
    max(num_pos, 1)."""
    anchors = torch.cat(anchors_per_level)
    cls_flat = torch.cat([c.reshape(-1, num_classes) for c in cls_scores])
    reg_flat = torch.cat([r.reshape(-1, 4) for r in bbox_preds])
    assign = max_iou_assign(anchors, gt_bboxes, pos_iou_thr=pos_iou_thr,
                            neg_iou_thr=neg_iou_thr, min_pos_iou=0.0,
                            gt_labels=gt_labels, gt_valid=gt_valid,
                            gt_max_assign_all=False)
    pos = assign.assigned_gt_inds > 0
    neg = assign.assigned_gt_inds == 0
    labels = torch.where(pos, assign.labels, torch.zeros_like(assign.labels))
    num_pos = pos.float().sum()
    ce = -F.log_softmax(cls_flat, -1).gather(-1, labels.long()[:, None])[:, 0]
    keep_neg = hard_negatives(ce, neg, num_pos, neg_pos_ratio)
    den = num_pos.clamp(min=1.0)
    loss_cls = (torch.where(pos | keep_neg, ce, torch.zeros_like(ce)).sum()
                / den)
    gt_idx = (assign.assigned_gt_inds - 1).clamp(0, gt_bboxes.shape[0] - 1)
    targets = bbox2delta(anchors, gt_bboxes[gt_idx], target_means, target_stds)
    loss_bbox = smooth_l1_loss(reg_flat, targets, beta=smoothl1_beta,
                               weight=pos.float()[:, None], avg_factor=den)
    return {"loss_cls": loss_cls, "loss_bbox": loss_bbox}


# FCOS's per-level regression ranges
FCOS_INF = 1e8
FCOS_REGRESS_RANGES = ((-1, 64), (64, 128), (128, 256), (256, 512),
                       (512, FCOS_INF))


def fcos_points(featmap_sizes, strides, device=None):
    """Per-level (H * W, 2) (x, y) points at stride * i + stride // 2."""
    points = []
    for (h, w), s in zip(featmap_sizes, strides):
        ys = torch.arange(h, dtype=torch.float32, device=device) * s + s // 2
        xs = torch.arange(w, dtype=torch.float32, device=device) * s + s // 2
        points.append(torch.stack([xs.repeat(h), ys.repeat_interleave(w)], -1))
    return points


def fcos_target(points, regress_ranges, gt_bboxes, gt_labels, gt_valid):
    """FCOS targets of one image: each point takes the smallest-area valid
    gt that contains it and whose largest distance is in the point's range
    (the first on equal areas). Returns (labels (N,), ltrb targets (N, 4))."""
    xs, ys = points[:, 0:1], points[:, 1:2]
    ltrb = torch.stack([xs - gt_bboxes[None, :, 0], ys - gt_bboxes[None, :, 1],
                        gt_bboxes[None, :, 2] - xs,
                        gt_bboxes[None, :, 3] - ys], -1)  # (N, G, 4)
    areas = ((gt_bboxes[:, 2] - gt_bboxes[:, 0] + 1)
             * (gt_bboxes[:, 3] - gt_bboxes[:, 1] + 1))[None, :]
    inside = ltrb.min(-1).values > 0
    max_dist = ltrb.max(-1).values
    in_range = ((max_dist >= regress_ranges[:, None, 0])
                & (max_dist <= regress_ranges[:, None, 1]))
    areas = torch.where(inside & in_range & gt_valid[None, :], areas,
                        torch.full_like(max_dist, FCOS_INF))
    min_area, min_idx = areas.min(1)
    labels = torch.where(min_area < FCOS_INF, gt_labels[min_idx],
                         torch.zeros_like(gt_labels[min_idx]))
    targets = ltrb.gather(1, min_idx[:, None, None].expand(-1, 1, 4))[:, 0]
    return labels, targets


def fcos_loss(cls_scores, bbox_preds, centernesses, strides, gt_bboxes,
              gt_labels, gt_valid, num_classes: int,
              regress_ranges=FCOS_REGRESS_RANGES):
    """FCOS's losses of one image: focal over every point (over
    num_pos + 1), the centerness-weighted IoU loss of the decoded boxes, and
    the centerness's cross entropy on the positives. Per-level maps are
    (H, W, C) channel-last."""
    fg = num_classes - 1
    dev = cls_scores[0].device
    points = fcos_points([c.shape[:2] for c in cls_scores], strides, dev)
    rr = torch.cat([torch.tensor(r, dtype=torch.float32, device=dev)[None]
                    .expand(p.shape[0], 2)
                    for r, p in zip(regress_ranges, points)])
    pts = torch.cat(points)
    labels, bbox_targets = fcos_target(pts, rr, gt_bboxes, gt_labels, gt_valid)
    cls_flat = torch.cat([c.reshape(-1, fg) for c in cls_scores])
    reg_flat = torch.cat([r.reshape(-1, 4) for r in bbox_preds])
    ctr_flat = torch.cat([c.reshape(-1) for c in centernesses])
    pos = labels > 0
    num_pos = pos.float().sum()
    loss_cls = sigmoid_focal_loss(cls_flat, labels,
                                  weight=torch.ones_like(cls_flat[:, 0]),
                                  avg_factor=num_pos + 1.0)
    # centerness targets, 0 on the non-positive rows (no 0 / 0)
    lr, tb = bbox_targets[:, 0::2], bbox_targets[:, 1::2]
    ctr_t = torch.sqrt(((lr.min(-1).values / lr.max(-1).values.clamp(min=1e-6))
                        * (tb.min(-1).values
                           / tb.max(-1).values.clamp(min=1e-6))).clamp(0.0,
                                                                       1.0))
    ctr_t = torch.where(pos, ctr_t, torch.zeros_like(ctr_t))

    def decode(d):
        return torch.stack([pts[:, 0] - d[:, 0], pts[:, 1] - d[:, 1],
                            pts[:, 0] + d[:, 2], pts[:, 1] + d[:, 3]], -1)

    loss_bbox = iou_loss(decode(reg_flat), decode(bbox_targets), weight=ctr_t,
                         avg_factor=ctr_t.sum().clamp(min=1e-6))
    loss_ctr = binary_cross_entropy_with_logits(
        ctr_flat, ctr_t, weight=pos.float(), avg_factor=num_pos.clamp(min=1.0))
    return {"loss_cls": loss_cls, "loss_bbox": loss_bbox,
            "loss_centerness": loss_ctr}


def fcos_bboxes(cls_scores, bbox_preds, centernesses, strides, img_shape,
                num_classes: int, nms_pre: int = 1000,
                score_thr: float = 0.05, nms_thr: float = 0.5,
                max_per_img: int = 100, nms_cfg=None):
    """FCOS decode of one image: per level the ``nms_pre`` best points by
    best class score x centerness, boxes from their distances clipped to
    the image, scores x centerness, then multiclass_nms."""
    fg = num_classes - 1
    points = fcos_points([c.shape[:2] for c in cls_scores], strides,
                         cls_scores[0].device)
    h, w = img_shape
    lvl_boxes, lvl_scores = [], []
    for cls, reg, ctr, pts in zip(cls_scores, bbox_preds, centernesses,
                                  points):
        scores = torch.sigmoid(cls.reshape(-1, fg))
        ctr_s = torch.sigmoid(ctr.reshape(-1))
        dist = reg.reshape(-1, 4)
        k = min(nms_pre, scores.shape[0])
        _, idx = top_k(scores.max(-1).values * ctr_s, k)
        p, d = pts[idx], dist[idx]
        lvl_boxes.append(torch.stack([
            (p[:, 0] - d[:, 0]).clamp(0, w), (p[:, 1] - d[:, 1]).clamp(0, h),
            (p[:, 0] + d[:, 2]).clamp(0, w), (p[:, 1] + d[:, 3]).clamp(0, h)],
            -1))
        lvl_scores.append(scores[idx] * ctr_s[idx][:, None])
    return padded_multiclass_nms(torch.cat(lvl_boxes), torch.cat(lvl_scores),
                                 score_thr, nms_thr, max_per_img, nms_cfg)
