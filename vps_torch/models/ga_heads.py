"""Guided-anchoring heads (port of vps_tpu/models/ga_heads.py):
GuidedAnchorHead, GARPNHead, GARetinaHead, and their pure anchor, target,
loss and decode functions: ``ga_generators``, ``guided_anchors_single``,
``ga_loc_targets``, ``ga_shape_targets``, ``ga_loc_shape_losses``,
``ga_loss``, ``ga_rpn_loss``, ``ga_bboxes``, ``ga_rpn_proposals``.

The heads take the FPN's NCHW levels, carry mmdet's state_dict names
(``conv_loc``, ``conv_shape``, ``feature_adaption.conv_offset``,
``feature_adaption.conv_adaption``, ``conv_cls``, ``conv_reg``,
``rpn_conv``, ``cls_convs.i.conv``, ``feature_adaption_cls``,
``retina_cls``, ...) and return per level (cls_score, bbox_pred,
shape_pred, loc_pred) maps channel-last, (B, H, W, C), JAX's layout, which
the functions take one image of ((1, H, W, C) each).

As in JAX the loc filter is a mask, never a boolean index: it multiplies
the masked convs' outputs (``ops/masked_conv.py``) and zeroes the filtered
scores before each level's ``top_k`` (ties in index order, as
``jax.lax.top_k``). The feature adaption is a deformable-group 3x3 conv
(``deform_conv2d_grouped``, plain PyTorch, as JAX's is an XLA
composition) inside the profiler range ``feature_adaption``. Gradients
stop where JAX stops them: the adaption's offsets and the guided anchors
see the shape (and loc) predictions detached; the shape loss does not.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from vps_torch.core.assigner import approx_max_iou_assign, max_iou_assign
from vps_torch.core.sampler import pseudo_sample, random_sample
from vps_torch.core.targets import anchor_target
from vps_torch.models.anchor_heads import padded_multiclass_nms
from vps_torch.models.layers import Conv, ConvModule
from vps_torch.models.reppoints import _DeformConvWeight
from vps_torch.ops.anchors import AnchorGenerator
from vps_torch.ops.box import bbox2delta, delta2bbox
from vps_torch.ops.deform_conv import deform_conv2d_grouped
from vps_torch.ops.losses import (
    binary_cross_entropy_with_logits,
    bounded_iou_loss,
    sigmoid_focal_loss,
    smooth_l1_loss,
)
from vps_torch.ops.masked_conv import masked_conv2d
from vps_torch.ops.nms import NEG_INF, nms, top_k
from vps_torch.registry import HEADS

PRIOR_BIAS = -math.log((1 - 0.01) / 0.01)  # sigmoid 0.01
SHAPE_CLIP = 1e-6  # the guided anchors' wh_ratio_clip


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


def _conv(cin, cout, k, std, bias, device, use_bias=True):
    conv = Conv(cin, cout, k, 1, (k - 1) // 2, bias=use_bias, device=device)
    nn.init.normal_(conv.weight, std=std)
    if use_bias:
        nn.init.constant_(conv.bias, bias)
    return conv


class FeatureAdaption(nn.Module):
    """Shape-conditioned feature adaption: a bias-free 1x1 ``conv_offset``
    on the detached shape prediction gives each deformable group's offsets;
    ``conv_adaption`` (a deformable-group conv) adapts the features; ReLU.
    NCHW x and shape_pred in, NHWC out."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, deformable_groups: int = 4,
                 device=None):
        super().__init__()
        k = kernel_size
        self.kernel_size = k
        self.deformable_groups = deformable_groups
        self.conv_offset = _conv(2, deformable_groups * k * k * 2, 1, 0.1,
                                 0.0, device, use_bias=False)
        self.conv_adaption = _DeformConvWeight((out_channels, in_channels,
                                                k, k), device)

    def forward(self, x, shape_pred):
        with torch.profiler.record_function("feature_adaption"):
            offs = _nhwc(self.conv_offset(shape_pred.detach()))
            out = deform_conv2d_grouped(
                _nhwc(x), offs, self.conv_adaption.weight,
                self.deformable_groups, padding=(self.kernel_size - 1) // 2)
        return F.relu(out)


class MaskedConv2d(nn.Module):
    """mmdet's MaskedConv2d parameters (``weight`` (Cout, Cin, k, k),
    ``bias``), applied by ``masked_conv2d`` to NHWC features."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 bias_init: float = 0.0, device=None):
        super().__init__()
        self.padding = (kernel_size - 1) // 2
        self.weight = nn.Parameter(torch.empty(
            out_channels, in_channels, kernel_size, kernel_size,
            device=device))
        self.bias = nn.Parameter(torch.full((out_channels,), bias_init,
                                            device=device))
        nn.init.normal_(self.weight, std=0.01)

    def forward(self, x, mask):
        return masked_conv2d(x, mask, self.weight, self.bias, self.padding)


class _GABase(nn.Module):
    """The anchoring settings every GA head has, and the loc mask. Modules
    are shared over the levels."""

    def _settings(self, num_classes, octave_base_scale, scales_per_octave,
                  octave_ratios, anchor_strides, anchoring_means,
                  anchoring_stds, target_means, target_stds,
                  deformable_groups, loc_filter_thr, use_sigmoid_cls):
        self.num_classes = num_classes
        self.octave_base_scale = octave_base_scale
        self.scales_per_octave = scales_per_octave
        self.octave_ratios = tuple(octave_ratios)
        self.anchor_strides = tuple(anchor_strides)
        self.anchoring_means = tuple(anchoring_means)
        self.anchoring_stds = tuple(anchoring_stds)
        self.target_means = tuple(target_means)
        self.target_stds = tuple(target_stds)
        self.deformable_groups = deformable_groups
        self.loc_filter_thr = loc_filter_thr
        self.use_sigmoid_cls = use_sigmoid_cls

    @property
    def cls_out_channels(self) -> int:
        return self.num_classes - 1 if self.use_sigmoid_cls \
            else self.num_classes

    def _mask(self, loc_pred, masked: bool):
        """(B, H, W) bool: sigmoid(loc) >= loc_filter_thr, or all True."""
        if masked:
            return torch.sigmoid(_nhwc(loc_pred)[..., 0]) >= self.loc_filter_thr
        b, _, h, w = loc_pred.shape
        return torch.ones((b, h, w), dtype=torch.bool, device=loc_pred.device)


class _GATail(_GABase):
    """GuidedAnchorHead's and GARPNHead's tail: 1x1 loc and shape convs, one
    feature adaption, 1x1 masked cls and reg convs."""

    def _tail(self, in_channels, feat_channels, cls_channels, device):
        self.conv_loc = _conv(in_channels, 1, 1, 0.01, PRIOR_BIAS, device)
        self.conv_shape = _conv(in_channels, 2, 1, 0.01, 0.0, device)
        self.feature_adaption = FeatureAdaption(
            in_channels, feat_channels, 3, self.deformable_groups, device)
        self.conv_cls = MaskedConv2d(feat_channels, cls_channels, 1,
                                     device=device)
        self.conv_reg = MaskedConv2d(feat_channels, 4, 1, device=device)

    def _apply_tail(self, x, masked: bool):
        loc_pred, shape_pred = self.conv_loc(x), self.conv_shape(x)
        xa = self.feature_adaption(x, shape_pred)
        mask = self._mask(loc_pred, masked)
        return (self.conv_cls(xa, mask), self.conv_reg(xa, mask),
                _nhwc(shape_pred), _nhwc(loc_pred))

    def forward(self, feats, masked: bool = False):
        outs = [self._apply_tail(self._stem(f), masked) for f in feats]
        return tuple(list(o) for o in zip(*outs))

    def _stem(self, x):
        return x


@HEADS.register
class GuidedAnchorHead(_GATail):
    """One square anchor a location, shape and loc branches, the feature
    adaption, masked cls and reg. ``num_classes`` counts the background
    (mmdet 1.x). Returns per level (cls (B, H, W, C'), reg (B, H, W, 4),
    shape (B, H, W, 2), loc (B, H, W, 1))."""

    def __init__(self, num_classes: int = 81, in_channels: int = 256,
                 feat_channels: int = 256, octave_base_scale: int = 8,
                 scales_per_octave: int = 3,
                 octave_ratios: Sequence[float] = (0.5, 1.0, 2.0),
                 anchor_strides: Sequence[int] = (4, 8, 16, 32, 64),
                 anchoring_means=(0.0, 0.0, 0.0, 0.0),
                 anchoring_stds=(1.0, 1.0, 1.0, 1.0),
                 target_means=(0.0, 0.0, 0.0, 0.0),
                 target_stds=(1.0, 1.0, 1.0, 1.0),
                 deformable_groups: int = 4, loc_filter_thr: float = 0.01,
                 use_sigmoid_cls: bool = True, device=None):
        super().__init__()
        self._settings(num_classes, octave_base_scale, scales_per_octave,
                       octave_ratios, anchor_strides, anchoring_means,
                       anchoring_stds, target_means, target_stds,
                       deformable_groups, loc_filter_thr, use_sigmoid_cls)
        self._tail(in_channels, feat_channels, self.cls_out_channels, device)


@HEADS.register
class GARPNHead(_GATail):
    """GA-RPN: a 3x3 ``rpn_conv`` + ReLU stem, then the guided-anchoring
    tail with one sigmoid objectness channel."""

    def __init__(self, in_channels: int = 256, feat_channels: int = 256,
                 octave_base_scale: int = 8, scales_per_octave: int = 3,
                 octave_ratios: Sequence[float] = (0.5, 1.0, 2.0),
                 anchor_strides: Sequence[int] = (4, 8, 16, 32, 64),
                 anchoring_means=(0.0, 0.0, 0.0, 0.0),
                 anchoring_stds=(1.0, 1.0, 1.0, 1.0),
                 target_means=(0.0, 0.0, 0.0, 0.0),
                 target_stds=(1.0, 1.0, 1.0, 1.0),
                 deformable_groups: int = 4, loc_filter_thr: float = 0.01,
                 num_classes: int = 2, use_sigmoid_cls: bool = True,
                 device=None):
        super().__init__()
        self._settings(num_classes, octave_base_scale, scales_per_octave,
                       octave_ratios, anchor_strides, anchoring_means,
                       anchoring_stds, target_means, target_stds,
                       deformable_groups, loc_filter_thr, use_sigmoid_cls)
        self.rpn_conv = _conv(in_channels, feat_channels, 3, 0.01, 0.0,
                              device)
        self._tail(feat_channels, feat_channels, 1, device)

    @property
    def cls_out_channels(self) -> int:
        return 1

    def _stem(self, x):
        return F.relu(self.rpn_conv(x))


@HEADS.register
class GARetinaHead(_GABase):
    """GA-RetinaNet: ``stacked_convs`` 3x3 conv + ReLU towers (``cls_convs``,
    ``reg_convs``), loc from the class tower, shape from the box tower, a
    feature adaption for each branch, masked 3x3 ``retina_cls`` and
    ``retina_reg``."""

    def __init__(self, num_classes: int = 81, in_channels: int = 256,
                 feat_channels: int = 256, stacked_convs: int = 4,
                 octave_base_scale: int = 4, scales_per_octave: int = 3,
                 octave_ratios: Sequence[float] = (0.5, 1.0, 2.0),
                 anchor_strides: Sequence[int] = (8, 16, 32, 64, 128),
                 anchoring_means=(0.0, 0.0, 0.0, 0.0),
                 anchoring_stds=(1.0, 1.0, 1.0, 1.0),
                 target_means=(0.0, 0.0, 0.0, 0.0),
                 target_stds=(1.0, 1.0, 1.0, 1.0),
                 deformable_groups: int = 4, loc_filter_thr: float = 0.01,
                 use_sigmoid_cls: bool = True, device=None):
        super().__init__()
        self._settings(num_classes, octave_base_scale, scales_per_octave,
                       octave_ratios, anchor_strides, anchoring_means,
                       anchoring_stds, target_means, target_stds,
                       deformable_groups, loc_filter_thr, use_sigmoid_cls)
        self.stacked_convs = stacked_convs

        def tower():
            convs = nn.ModuleList(
                ConvModule(in_channels if i == 0 else feat_channels,
                           feat_channels, 3, 1, 1, device=device)
                for i in range(stacked_convs))
            for m in convs:
                nn.init.normal_(m.conv.weight, std=0.01)
                nn.init.zeros_(m.conv.bias)
            return convs

        self.cls_convs = tower()
        self.reg_convs = tower()
        self.conv_loc = _conv(feat_channels, 1, 1, 0.01, PRIOR_BIAS, device)
        self.conv_shape = _conv(feat_channels, 2, 1, 0.01, 0.0, device)
        self.feature_adaption_cls = FeatureAdaption(
            feat_channels, feat_channels, 3, deformable_groups, device)
        self.feature_adaption_reg = FeatureAdaption(
            feat_channels, feat_channels, 3, deformable_groups, device)
        self.retina_cls = MaskedConv2d(feat_channels, self.cls_out_channels,
                                       3, bias_init=PRIOR_BIAS, device=device)
        self.retina_reg = MaskedConv2d(feat_channels, 4, 3, device=device)

    def forward(self, feats, masked: bool = False):
        outs = []
        for f in feats:
            c, r = f, f
            for conv in self.cls_convs:
                c = conv(c)
            for conv in self.reg_convs:
                r = conv(r)
            loc_pred, shape_pred = self.conv_loc(c), self.conv_shape(r)
            ca = self.feature_adaption_cls(c, shape_pred)
            ra = self.feature_adaption_reg(r, shape_pred)
            mask = self._mask(loc_pred, masked)
            outs.append((self.retina_cls(ca, mask), self.retina_reg(ra, mask),
                         _nhwc(shape_pred), _nhwc(loc_pred)))
        return tuple(list(o) for o in zip(*outs))


# ---------------------------------------------------------------------------
# anchors and guided anchors


def ga_generators(head):
    """Per level the (approx, square) anchor generators: the octave's
    scales x ratios, and one square of ``octave_base_scale``."""
    octave_scales = [head.octave_base_scale * 2 ** (i / head.scales_per_octave)
                     for i in range(head.scales_per_octave)]
    approx = [AnchorGenerator(s, octave_scales, list(head.octave_ratios))
              for s in head.anchor_strides]
    square = [AnchorGenerator(s, [head.octave_base_scale], [1.0])
              for s in head.anchor_strides]
    return approx, square


def _grid(gens, featmap_sizes, strides, device):
    return [g.grid_anchors(tuple(s), st, device=device)
            for g, s, st in zip(gens, featmap_sizes, strides)]


def guided_anchors_single(squares, shape_pred, loc_pred,
                          anchoring_means=(0.0, 0.0, 0.0, 0.0),
                          anchoring_stds=(1.0, 1.0, 1.0, 1.0),
                          loc_filter_thr: float = 0.01,
                          use_loc_filter: bool = False):
    """One level's guided anchors and loc mask: every location's square
    widened by the (detached) shape prediction (dw, dh), its centre kept;
    the mask is sigmoid(loc) >= loc_filter_thr (>= 0 without the filter).
    squares (H * W, 4), shape_pred (H, W, 2), loc_pred (H, W, 1)."""
    loc = torch.sigmoid(loc_pred[..., 0].detach()).reshape(-1)
    mask = loc >= (loc_filter_thr if use_loc_filter else 0.0)
    sp = shape_pred.detach().reshape(-1, 2)
    deltas = torch.cat([torch.zeros_like(sp), sp], -1)
    guided = delta2bbox(squares, deltas, means=anchoring_means,
                        stds=anchoring_stds, wh_ratio_clip=SHAPE_CLIP)
    return guided, mask


# ---------------------------------------------------------------------------
# targets


def _region_mask(gt, ratio: float, h: int, w: int):
    """(G, H, W): the cells inside each gt's region shrunk by ``ratio``
    (edges rounded half to even, clipped to the map)."""
    x1 = torch.round((1 - ratio) * gt[:, 0] + ratio * gt[:, 2]).clamp(0, w - 1)
    y1 = torch.round((1 - ratio) * gt[:, 1] + ratio * gt[:, 3]).clamp(0, h - 1)
    x2 = torch.round(ratio * gt[:, 0] + (1 - ratio) * gt[:, 2]).clamp(0, w - 1)
    y2 = torch.round(ratio * gt[:, 1] + (1 - ratio) * gt[:, 3]).clamp(0, h - 1)
    ys = torch.arange(h, dtype=torch.float32, device=gt.device)
    xs = torch.arange(w, dtype=torch.float32, device=gt.device)
    in_y = (ys[None, :] >= y1[:, None]) & (ys[None, :] <= y2[:, None])
    in_x = (xs[None, :] >= x1[:, None]) & (xs[None, :] <= x2[:, None])
    return in_y[:, :, None] & in_x[:, None, :]


def ga_loc_targets(gt_bboxes, gt_valid, featmap_sizes, anchor_scale: int,
                   anchor_strides: Sequence[int], center_ratio: float = 0.2,
                   ignore_ratio: float = 0.5):
    """Location targets of ONE image: each valid gt paints its centre region
    (target 1, weight 1) and its ignore region (weight 0) on the level its
    size maps to, and ignore regions on the two adjacent levels; weight 0.1
    elsewhere. A centre region wins over any ignore region, whatever the
    gts' order. Returns per level ((H, W) target, (H, W) weight), and the
    loss's avg factor (all cells / 200)."""
    num_lvls = len(featmap_sizes)
    r1 = (1 - center_ratio) / 2
    r2 = (1 - ignore_ratio) / 2
    scale = torch.sqrt((gt_bboxes[:, 2] - gt_bboxes[:, 0] + 1)
                       * (gt_bboxes[:, 3] - gt_bboxes[:, 1] + 1))
    min_size = float(anchor_scale * anchor_strides[0])
    lvls = torch.floor(torch.log2(scale.clamp(min=1e-6) / min_size) + 0.5)
    lvls = lvls.clamp(0, num_lvls - 1).long()
    out = []
    for lvl, (h, w) in enumerate(featmap_sizes):
        gl = gt_bboxes / anchor_strides[lvl]
        own = (gt_valid & (lvls == lvl))[:, None, None]
        adj = (gt_valid & ((lvls == lvl - 1) | (lvls == lvl + 1)))[:, None,
                                                                   None]
        ign_region = _region_mask(gl, r2, h, w)
        ctr = (_region_mask(gl, r1, h, w) & own).any(0)
        ign = ((ign_region & own) | (ign_region & adj)).any(0)
        target = ctr.float()
        weight = torch.where(ctr, torch.ones_like(target),
                             torch.where(ign, torch.zeros_like(target),
                                         torch.full_like(target, 0.1)))
        out.append((target, weight))
    return out, sum(h * w for h, w in featmap_sizes) / 200.0


def ga_shape_targets(generator, approxs, squares, gt_bboxes, gt_valid,
                     ga_assigner: Dict[str, Any], approxs_per_octave: int,
                     inside=None, sampler: Optional[Dict[str, Any]] = None):
    """Shape targets of ONE image over the flat (all-level) squares: each
    location assigned by its approxs' largest IoU, sampled (every location
    without ``sampler``; else ``random_sample`` of ``num`` at
    ``pos_fraction``), and each positive's gt box. Returns (bbox_gts (N, 4),
    weights (N,), num_pos)."""
    assign = approx_max_iou_assign(
        approxs, gt_bboxes, pos_iou_thr=ga_assigner["pos_iou_thr"],
        neg_iou_thr=ga_assigner["neg_iou_thr"],
        min_pos_iou=ga_assigner.get("min_pos_iou", 0.0),
        approxs_per_octave=approxs_per_octave, bbox_valid=inside,
        gt_valid=gt_valid)
    n = squares.shape[0]
    gi = assign.assigned_gt_inds
    if sampler is None:
        sample = pseudo_sample(gi, n)
    else:
        sample = random_sample(generator, gi, sampler["num"],
                               sampler["pos_fraction"])
    # the slots' indices are distinct: a positive slot sets its square's 1
    pos_slot = (sample.pos_mask & sample.valid).float()
    weights = squares.new_zeros(n).scatter(0, sample.inds, pos_slot)
    gt_idx = (gi - 1).clamp(0, gt_bboxes.shape[0] - 1)
    bbox_gts = torch.where((gi > 0)[:, None], gt_bboxes[gt_idx],
                           torch.zeros((), device=squares.device))
    return bbox_gts, weights, weights.sum().clamp(min=1.0)


# ---------------------------------------------------------------------------
# losses


def _ga_guided_flat(head, square_gen, shape_preds, loc_preds, featmap_sizes):
    dev = shape_preds[0].device
    return torch.cat([
        guided_anchors_single(sq, sp[0], lp[0], head.anchoring_means,
                              head.anchoring_stds)[0]
        for sq, sp, lp in zip(_grid(square_gen, featmap_sizes,
                                    head.anchor_strides, dev),
                              shape_preds, loc_preds)])


def ga_loc_shape_losses(generator, head, shape_preds, loc_preds,
                        featmap_sizes, gt_bboxes, gt_valid,
                        cfg: Dict[str, Any]):
    """The anchoring losses every GA head trains: focal loss of the loc
    maps, bounded-IoU loss of the squares the shape maps widen (not
    detached) against their approx-assigned gt. Returns (loss_loc,
    loss_shape)."""
    approx_gen, square_gen = ga_generators(head)
    dev = shape_preds[0].device
    loc_list, loc_avg = ga_loc_targets(
        gt_bboxes, gt_valid, featmap_sizes, head.octave_base_scale,
        list(head.anchor_strides), center_ratio=cfg.get("center_ratio", 0.2),
        ignore_ratio=cfg.get("ignore_ratio", 0.5))
    loss_loc = 0.0
    for (t, w), loc in zip(loc_list, loc_preds):
        loss_loc = loss_loc + sigmoid_focal_loss(
            loc[0].reshape(-1, 1), t.reshape(-1).long(), weight=w.reshape(-1),
            avg_factor=loc_avg)
    # location-major grids, each location's approxs contiguous: the
    # grouping approx_max_iou_assign expects
    approxs = torch.cat(_grid(approx_gen, featmap_sizes, head.anchor_strides,
                              dev))
    squares = torch.cat(_grid(square_gen, featmap_sizes, head.anchor_strides,
                              dev))
    apo = head.scales_per_octave * len(head.octave_ratios)
    bbox_gts, shape_w, shape_pos = ga_shape_targets(
        generator, approxs, squares, gt_bboxes, gt_valid, cfg["ga_assigner"],
        apo, sampler=cfg.get("ga_sampler"))
    shape_flat = torch.cat([s[0].reshape(-1, 2) for s in shape_preds])
    deltas = torch.cat([torch.zeros_like(shape_flat), shape_flat], -1)
    pred_anchors = delta2bbox(squares, deltas, means=head.anchoring_means,
                              stds=head.anchoring_stds,
                              wh_ratio_clip=SHAPE_CLIP)
    loss_shape = bounded_iou_loss(pred_anchors, bbox_gts, beta=0.2,
                                  weight=shape_w, avg_factor=shape_pos)
    return loss_loc, loss_shape


def ga_loss(generator, head, cls_scores, bbox_preds, shape_preds, loc_preds,
            gt_bboxes, gt_labels, gt_valid, img_shape: Tuple[int, int],
            cfg: Dict[str, Any], loc_weight: float = 1.0,
            shape_weight: float = 1.0):
    """GuidedAnchorHead's (and GARetinaHead's) loss of ONE image: the
    anchoring losses, then focal classification over every non-ignored
    guided anchor (MaxIoU, no sampling) and smooth L1 (beta 1/9) of the
    positives' deltas. Per-level maps (1, H, W, C)."""
    featmap_sizes = [tuple(c.shape[1:3]) for c in cls_scores]
    _, square_gen = ga_generators(head)
    loss_loc, loss_shape = ga_loc_shape_losses(
        generator, head, shape_preds, loc_preds, featmap_sizes, gt_bboxes,
        gt_valid, cfg)
    guided_flat = _ga_guided_flat(head, square_gen, shape_preds, loc_preds,
                                  featmap_sizes)
    a = cfg["assigner"]
    assign = max_iou_assign(guided_flat, gt_bboxes,
                            pos_iou_thr=a["pos_iou_thr"],
                            neg_iou_thr=a["neg_iou_thr"],
                            min_pos_iou=a.get("min_pos_iou", 0.0),
                            gt_labels=gt_labels, gt_valid=gt_valid)
    pos = assign.assigned_gt_inds > 0
    neg = assign.assigned_gt_inds == 0
    labels = torch.where(pos, assign.labels, torch.zeros_like(assign.labels))
    npos = pos.float().sum().clamp(min=1.0)
    fg = head.cls_out_channels
    cls_flat = torch.cat([c[0].reshape(-1, fg) for c in cls_scores])
    reg_flat = torch.cat([r[0].reshape(-1, 4) for r in bbox_preds])
    loss_cls = sigmoid_focal_loss(cls_flat, labels, weight=(pos | neg).float(),
                                  avg_factor=npos)
    gt_idx = (assign.assigned_gt_inds - 1).clamp(0, gt_bboxes.shape[0] - 1)
    tdeltas = bbox2delta(guided_flat, gt_bboxes[gt_idx], head.target_means,
                         head.target_stds)
    loss_bbox = smooth_l1_loss(reg_flat, tdeltas, beta=1.0 / 9.0,
                               weight=pos.float()[:, None], avg_factor=npos)
    return {"loss_cls": loss_cls, "loss_bbox": loss_bbox,
            "loss_shape": loss_shape * shape_weight,
            "loss_loc": loss_loc * loc_weight}


def ga_rpn_loss(generator, head, cls_scores, bbox_preds, shape_preds,
                loc_preds, gt_bboxes, gt_valid, img_shape: Tuple[int, int],
                cfg: Dict[str, Any]):
    """GA-RPN's loss of ONE image: the anchoring losses, then the RPN's
    sampled objectness cross entropy and smooth L1 (beta 1/9) over the
    guided anchors through ``anchor_target`` (cfg's assigner, sampler and
    allowed_border)."""
    featmap_sizes = [tuple(c.shape[1:3]) for c in cls_scores]
    _, square_gen = ga_generators(head)
    loss_loc, loss_shape = ga_loc_shape_losses(
        generator, head, shape_preds, loc_preds, featmap_sizes, gt_bboxes,
        gt_valid, cfg)
    guided_flat = _ga_guided_flat(head, square_gen, shape_preds, loc_preds,
                                  featmap_sizes)
    tgt = anchor_target(
        generator, guided_flat,
        torch.ones(guided_flat.shape[0], dtype=torch.bool,
                   device=guided_flat.device),
        gt_bboxes, gt_valid, img_shape, cfg, target_means=head.target_means,
        target_stds=head.target_stds)
    cls_flat = torch.cat([c[0].reshape(-1) for c in cls_scores])
    reg_flat = torch.cat([r[0].reshape(-1, 4) for r in bbox_preds])
    num = (tgt.num_pos + tgt.num_neg).clamp(min=1).float()
    return {"loss_rpn_cls": binary_cross_entropy_with_logits(
                cls_flat, tgt.labels.float(), weight=tgt.label_weights,
                avg_factor=num),
            "loss_rpn_bbox": smooth_l1_loss(
                reg_flat, tgt.bbox_targets, beta=1.0 / 9.0,
                weight=tgt.bbox_weights, avg_factor=num),
            "loss_anchor_shape": loss_shape,
            "loss_anchor_loc": loss_loc}


# ---------------------------------------------------------------------------
# decode


def _guided_levels(head, cls_scores, shape_preds, loc_preds, use_loc_filter):
    """Per level (guided anchors, loc mask) of one image."""
    _, square_gen = ga_generators(head)
    sizes = [tuple(c.shape[1:3]) for c in cls_scores]
    squares = _grid(square_gen, sizes, head.anchor_strides,
                    cls_scores[0].device)
    return [guided_anchors_single(sq, sp[0], lp[0], head.anchoring_means,
                                  head.anchoring_stds, head.loc_filter_thr,
                                  use_loc_filter)
            for sq, sp, lp in zip(squares, shape_preds, loc_preds)]


def ga_bboxes(head, cls_scores, bbox_preds, shape_preds, loc_preds,
              img_shape: Tuple[int, int], nms_pre: int = 1000,
              score_thr: float = 0.05, nms_thr: float = 0.5,
              max_per_img: int = 100, use_loc_filter: bool = True,
              nms_cfg=None):
    """Detections of ONE image: per level the loc-masked class scores (0 at
    a filtered location), the ``nms_pre`` best locations by their best
    class, decoded on their guided anchors and clipped, then one
    multiclass_nms. Returns (dets (max, 5), labels (max,) 0-based, valid
    (max,))."""
    fg = head.cls_out_channels
    lvl_boxes, lvl_scores = [], []
    for (anchors, mask), cls, reg in zip(
            _guided_levels(head, cls_scores, shape_preds, loc_preds,
                           use_loc_filter), cls_scores, bbox_preds):
        if head.use_sigmoid_cls:
            scores = torch.sigmoid(cls[0].reshape(-1, fg))
        else:
            scores = F.softmax(cls[0].reshape(-1, fg), -1)[:, 1:]
        scores = torch.where(mask[:, None], scores, torch.zeros_like(scores))
        deltas = reg[0].reshape(-1, 4)
        _, idx = top_k(scores.max(-1).values, min(nms_pre, scores.shape[0]))
        lvl_boxes.append(delta2bbox(anchors[idx], deltas[idx],
                                    max_shape=img_shape,
                                    means=head.target_means,
                                    stds=head.target_stds))
        lvl_scores.append(scores[idx])
    return padded_multiclass_nms(torch.cat(lvl_boxes), torch.cat(lvl_scores),
                                 score_thr, nms_thr, max_per_img, nms_cfg)


def ga_rpn_proposals(head, cls_scores, bbox_preds, shape_preds, loc_preds,
                     img_shape: Tuple[int, int], nms_pre: int = 2000,
                     nms_thr: float = 0.7, max_num: int = 2000,
                     min_bbox_size: float = 0.0, use_loc_filter: bool = True):
    """GA-RPN proposals of ONE image: per level the loc-masked objectness,
    its ``nms_pre`` best decoded on their guided anchors (boxes narrower
    than ``min_bbox_size`` scored 0), NMS; then the ``max_num`` best over
    the levels. Fixed capacity, as rpn_proposals: (proposals (max_num, 4),
    scores (max_num,), valid (max_num,)), NEG_INF-padded slots invalid and
    zeroed."""
    all_boxes, all_scores = [], []
    for (anchors, mask), cls, reg in zip(
            _guided_levels(head, cls_scores, shape_preds, loc_preds,
                           use_loc_filter), cls_scores, bbox_preds):
        scores = torch.sigmoid(cls[0].reshape(-1))
        scores = torch.where(mask, scores, torch.zeros_like(scores))
        deltas = reg[0].reshape(-1, 4)
        top_scores, idx = top_k(scores, min(nms_pre, scores.shape[0]))
        boxes = delta2bbox(anchors[idx], deltas[idx], max_shape=img_shape,
                           means=head.target_means, stds=head.target_stds)
        if min_bbox_size > 0:
            bw = boxes[:, 2] - boxes[:, 0] + 1
            bh = boxes[:, 3] - boxes[:, 1] + 1
            top_scores = torch.where((bw >= min_bbox_size)
                                     & (bh >= min_bbox_size), top_scores,
                                     torch.zeros_like(top_scores))
        keep = nms(boxes, top_scores, nms_thr)
        all_boxes.append(boxes)
        all_scores.append(torch.where(keep, top_scores,
                                      torch.full_like(top_scores, NEG_INF)))
    boxes = torch.cat(all_boxes)
    scores = torch.cat(all_scores)
    k = min(max_num, scores.shape[0])
    top_scores, idx = top_k(scores, k)
    proposals = boxes[idx]
    valid = top_scores > NEG_INF / 2
    if k < max_num:
        pad = max_num - k
        proposals = F.pad(proposals, (0, 0, 0, pad))
        top_scores = F.pad(top_scores, (0, pad), value=NEG_INF)
        valid = F.pad(valid, (0, pad))
    proposals = torch.where(valid[:, None], proposals,
                            torch.zeros_like(proposals))
    return proposals, top_scores.clamp(min=0.0), valid
