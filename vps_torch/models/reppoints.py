"""RepPoints head (port of vps_tpu/models/reppoints.py): per-level conv towers
predict an initial point set of ``num_points`` (y, x) offsets in strides; a
deformable conv sampled at those points (their gradient blended by
``gradient_mul``, the base grid subtracted) gives the features of the
classifier and of the refined points. Point sets become boxes by the
``minmax``, ``partial_minmax`` or ``moment`` transform (``points2bbox``).

The module is NCHW with mmdet's state_dict names (``cls_convs.i.conv``,
``reppoints_cls_conv``, ``reppoints_pts_init_out``, ``moment_transfer``,
...). The two deformable convs a level are ``vps_torch.ops.deform_conv.
deform_conv2d``'s plain form, as JAX's are an XLA composition, and their
backward is autograd through it. ``reppoints_loss`` assigns the init stage
by ``point_assign`` and the refine stage by MaxIoU over the detached init
boxes; ``reppoints_bboxes`` decodes. Their per-level maps are (1, H, W, C)
channel-last, JAX's layout.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from vps_torch.core.assigner import max_iou_assign, point_assign
from vps_torch.models.anchor_heads import padded_multiclass_nms
from vps_torch.models.layers import Conv, ConvModule
from vps_torch.ops.deform_conv import deform_conv2d
from vps_torch.ops.losses import sigmoid_focal_loss, smooth_l1_loss
from vps_torch.ops.nms import top_k
from vps_torch.registry import HEADS


def _dcn_base_offset(kernel: int) -> np.ndarray:
    """The (1, 1, 1, 2K) y-first base grid subtracted from the predicted
    points to form the DCN's offsets."""
    pad = (kernel - 1) // 2
    base = np.arange(-pad, pad + 1, dtype=np.float32)
    dy = np.repeat(base, kernel)
    dx = np.tile(base, kernel)
    return np.stack([dy, dx], axis=1).reshape(1, 1, 1, -1)


def _grad_mul(x, mul: float):
    """x's value with ``mul`` of its gradient: (1 - mul) * x.detach() +
    mul * x."""
    return (1 - mul) * x.detach() + mul * x


@HEADS.register
class RepPointsHead(nn.Module):
    """Returns per-level (cls_score (B, fg, H, W), pts_init (B, 2K, H, W),
    pts_refine (B, 2K, H, W)), the points y-first."""

    def __init__(self, num_classes: int = 81, in_channels: int = 256,
                 feat_channels: int = 256, point_feat_channels: int = 256,
                 stacked_convs: int = 3, num_points: int = 9,
                 gradient_mul: float = 0.1,
                 point_strides: Sequence[int] = (8, 16, 32, 64, 128),
                 point_base_scale: int = 4, transform_method: str = "moment",
                 moment_mul: float = 0.01, use_grid_points: bool = False,
                 center_init: bool = True, device=None):
        super().__init__()
        k = int(math.sqrt(num_points))
        if k * k != num_points or k % 2 != 1:
            raise ValueError(f"num_points {num_points}: an odd square")
        self.num_classes = num_classes
        self.num_points = num_points
        self.dcn_kernel = k
        self.gradient_mul = gradient_mul
        self.point_strides = tuple(point_strides)
        self.point_base_scale = point_base_scale
        self.transform_method = transform_method
        self.moment_mul = moment_mul
        fg = num_classes - 1
        pts_out = 2 * num_points
        self.cls_convs = nn.ModuleList(
            ConvModule(in_channels if i == 0 else feat_channels,
                       feat_channels, 3, 1, 1, device=device)
            for i in range(stacked_convs))
        self.reg_convs = nn.ModuleList(
            ConvModule(in_channels if i == 0 else feat_channels,
                       feat_channels, 3, 1, 1, device=device)
            for i in range(stacked_convs))
        dcn_shape = (point_feat_channels, feat_channels, k, k)
        self.reppoints_cls_conv = _DeformConvWeight(dcn_shape, device)
        self.reppoints_cls_out = Conv(point_feat_channels, fg, 1, 1, 0,
                                      device=device)
        self.reppoints_pts_init_conv = Conv(feat_channels, point_feat_channels,
                                            3, 1, 1, device=device)
        self.reppoints_pts_init_out = Conv(point_feat_channels, pts_out, 1, 1,
                                           0, device=device)
        self.reppoints_pts_refine_conv = _DeformConvWeight(dcn_shape, device)
        self.reppoints_pts_refine_out = Conv(point_feat_channels, pts_out, 1,
                                             1, 0, device=device)
        self.moment_transfer = (nn.Parameter(torch.zeros(2, device=device))
                                if transform_method == "moment" else None)
        self.register_buffer("dcn_base_offset",
                             torch.from_numpy(_dcn_base_offset(k)).to(device),
                             persistent=False)

    def _dcn(self, x, offset, weight):
        """ReLU(deform_conv2d) of NCHW x at NHWC offsets -> NCHW, in the
        named profiler range ``reppoints_dcn``."""
        with torch.profiler.record_function("reppoints_dcn"):
            out = deform_conv2d(x.permute(0, 2, 3, 1), offset, weight,
                                padding=(self.dcn_kernel - 1) // 2)
        return F.relu(out).permute(0, 3, 1, 2)

    def forward(self, feats):
        cls_scores, pts_inits, pts_refines = [], [], []
        for f in feats:
            c, r = f, f
            for conv in self.cls_convs:
                c = conv(c)
            for conv in self.reg_convs:
                r = conv(r)
            pts_init = self.reppoints_pts_init_out(
                F.relu(self.reppoints_pts_init_conv(r)))
            # the features move with the points, but only gradient_mul of
            # the refine stage's gradient reaches the init branch
            dcn_off = (_grad_mul(pts_init, self.gradient_mul)
                       .permute(0, 2, 3, 1) - self.dcn_base_offset)
            cls_feat = self._dcn(c, dcn_off, self.reppoints_cls_conv.weight)
            cls_scores.append(self.reppoints_cls_out(cls_feat))
            ref_feat = self._dcn(r, dcn_off,
                                 self.reppoints_pts_refine_conv.weight)
            pts_refines.append(self.reppoints_pts_refine_out(ref_feat)
                               + pts_init.detach())
            pts_inits.append(pts_init)
        return cls_scores, pts_inits, pts_refines


class _DeformConvWeight(nn.Module):
    """Holds a deformable conv's (Cout, Cin, k, k) weight under mmdet's name
    (``<conv>.weight``; no bias)."""

    def __init__(self, shape, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(shape, device=device))
        nn.init.normal_(self.weight, std=0.01)


def points2bbox(head, pts, moment_transfer=None, y_first: bool = True):
    """Point sets (..., 2K) -> boxes (..., 4) by ``head.transform_method``.
    ``moment_transfer``: the learned (2,) log-scales of the moment
    transform, blended by ``head.moment_mul`` with their detached copy."""
    p = pts.reshape(*pts.shape[:-1], -1, 2)
    py = p[..., 0] if y_first else p[..., 1]
    px = p[..., 1] if y_first else p[..., 0]
    method = head.transform_method
    if method in ("minmax", "partial_minmax"):
        if method == "partial_minmax":
            px, py = px[..., :4], py[..., :4]
        x1, x2 = px.min(-1).values, px.max(-1).values
        y1, y2 = py.min(-1).values, py.max(-1).values
    elif method == "moment":
        mx, my = px.mean(-1), py.mean(-1)
        n = px.shape[-1]
        # torch.std's Bessel-corrected (n - 1) divisor
        sx = torch.sqrt(((px - mx[..., None]) ** 2).sum(-1) / max(n - 1, 1))
        sy = torch.sqrt(((py - my[..., None]) ** 2).sum(-1) / max(n - 1, 1))
        mt = moment_transfer
        if mt is None:
            mt = torch.zeros(2, device=pts.device)
        mt = mt * head.moment_mul + mt.detach() * (1 - head.moment_mul)
        hw = sx * torch.exp(mt[0])
        hh = sy * torch.exp(mt[1])
        x1, x2 = mx - hw, mx + hw
        y1, y2 = my - hh, my + hh
    else:
        raise NotImplementedError(method)
    return torch.stack([x1, y1, x2, y2], -1)


def reppoints_centers(featmap_sizes, strides, device=None):
    """Per-level (H * W, 3) = (x, y, stride) grid points."""
    out = []
    for (h, w), s in zip(featmap_sizes, strides):
        xs = torch.arange(w, dtype=torch.float32, device=device) * s
        ys = torch.arange(h, dtype=torch.float32, device=device) * s
        xx, yy = xs.repeat(h), ys.repeat_interleave(w)
        out.append(torch.stack([xx, yy, torch.full_like(xx, s)], -1))
    return out


def offsets_to_pts(head, centers, pts_preds):
    """Per-level point coordinates in the image, (H * W, 2K) x-first: each
    (y, x) offset times the stride plus the centre."""
    out = []
    for ctr, pred, stride in zip(centers, pts_preds, head.point_strides):
        p = pred[0].reshape(-1, head.num_points, 2)
        xy = torch.stack([p[..., 1], p[..., 0]], -1) * stride
        out.append((xy + ctr[:, None, :2]).reshape(-1, 2 * head.num_points))
    return out


def _shift(boxes, ctr, stride):
    return boxes * stride + torch.cat([ctr[:, :2], ctr[:, :2]], -1)


def reppoints_loss(head, cls_scores, pts_preds_init, pts_preds_refine,
                   gt_bboxes, gt_labels, gt_valid, cfg: Dict[str, Any]):
    """RepPoints' two-stage loss of one image: the init points assigned by
    ``point_assign``, the refine stage by MaxIoU over the init boxes (of
    the detached points and moment transfer); focal classification and
    smooth L1 of the boxes over point_base_scale x stride of each level.
    Per-level maps (1, H, W, C)."""
    mt = head.moment_transfer
    dev = cls_scores[0].device
    sizes = [tuple(c.shape[1:3]) for c in cls_scores]
    centers = reppoints_centers(sizes, head.point_strides, dev)
    pts_xy_init = offsets_to_pts(head, centers, pts_preds_init)
    pts_xy_refine = offsets_to_pts(head, centers, pts_preds_refine)
    g = gt_bboxes.shape[0]

    init_cfg = cfg.get("init", {})
    assign_init = point_assign(
        torch.cat(centers), gt_bboxes,
        scale=init_cfg.get("scale", head.point_base_scale),
        pos_num=init_cfg.get("pos_num", 1), gt_labels=gt_labels,
        gt_valid=gt_valid)
    pos_init = assign_init.assigned_gt_inds > 0
    bbox_gt_init = gt_bboxes[
        (assign_init.assigned_gt_inds - 1).clamp(0, g - 1)]
    npos_init = pos_init.float().sum().clamp(min=1.0)

    # the refine stage's candidates: the init boxes around each centre
    mt_d = None if mt is None else mt.detach()
    refine_cands = torch.cat([
        _shift(points2bbox(head, pred[0].detach().reshape(
            -1, 2 * head.num_points), moment_transfer=mt_d), ctr, stride)
        for pred, ctr, stride in zip(pts_preds_init, centers,
                                     head.point_strides)])
    a = cfg.get("refine", {}).get("assigner", {})
    assign_ref = max_iou_assign(
        refine_cands, gt_bboxes, pos_iou_thr=a.get("pos_iou_thr", 0.5),
        neg_iou_thr=a.get("neg_iou_thr", 0.4),
        min_pos_iou=a.get("min_pos_iou", 0.0), gt_labels=gt_labels,
        gt_valid=gt_valid)
    pos_ref = assign_ref.assigned_gt_inds > 0
    neg_ref = assign_ref.assigned_gt_inds == 0
    bbox_gt_refine = gt_bboxes[
        (assign_ref.assigned_gt_inds - 1).clamp(0, g - 1)]
    labels_ref = torch.where(pos_ref, assign_ref.labels,
                             torch.zeros_like(assign_ref.labels))
    npos_ref = pos_ref.float().sum().clamp(min=1.0)

    fg = head.num_classes - 1
    cls_flat = torch.cat([c[0].reshape(-1, fg) for c in cls_scores])
    loss_cls = sigmoid_focal_loss(cls_flat, labels_ref,
                                  weight=(pos_ref | neg_ref).float(),
                                  avg_factor=npos_ref)
    norms = torch.cat([
        torch.full((h * w,), float(head.point_base_scale * s), device=dev)
        for (h, w), s in zip(sizes, head.point_strides)])[:, None]
    bbox_pred_init = points2bbox(head, torch.cat(pts_xy_init),
                                 moment_transfer=mt, y_first=False)
    bbox_pred_refine = points2bbox(head, torch.cat(pts_xy_refine),
                                   moment_transfer=mt, y_first=False)
    loss_pts_init = smooth_l1_loss(
        bbox_pred_init / norms, bbox_gt_init / norms, beta=1.0 / 9.0,
        weight=pos_init.float()[:, None],
        avg_factor=npos_init) * cfg.get("init_loss_weight", 0.5)
    loss_pts_refine = smooth_l1_loss(
        bbox_pred_refine / norms, bbox_gt_refine / norms, beta=1.0 / 9.0,
        weight=pos_ref.float()[:, None], avg_factor=npos_ref)
    return {"loss_cls": loss_cls, "loss_pts_init": loss_pts_init,
            "loss_pts_refine": loss_pts_refine}


def reppoints_bboxes(head, cls_scores, pts_preds_refine,
                     img_shape: Tuple[int, int], nms_pre: int = 1000,
                     score_thr: float = 0.05, nms_thr: float = 0.5,
                     max_per_img: int = 100, nms_cfg=None):
    """Detections of one image: the refined point sets -> boxes (x stride
    + centre), clipped to the image; per level the ``nms_pre`` best by best
    class score, then multiclass_nms. Per-level maps (1, H, W, C)."""
    dev = cls_scores[0].device
    centers = reppoints_centers([tuple(c.shape[1:3]) for c in cls_scores],
                                head.point_strides, dev)
    fg = head.num_classes - 1
    h, w = img_shape
    lvl_boxes, lvl_scores = [], []
    for cls, pred, ctr, stride in zip(cls_scores, pts_preds_refine, centers,
                                      head.point_strides):
        scores = torch.sigmoid(cls[0].reshape(-1, fg))
        boxes = _shift(points2bbox(head,
                                   pred[0].reshape(-1, 2 * head.num_points),
                                   moment_transfer=head.moment_transfer),
                       ctr, stride)
        boxes = torch.stack([boxes[:, 0].clamp(0, w), boxes[:, 1].clamp(0, h),
                             boxes[:, 2].clamp(0, w), boxes[:, 3].clamp(0, h)],
                            -1)
        _, idx = top_k(scores.max(-1).values, min(nms_pre, scores.shape[0]))
        lvl_boxes.append(boxes[idx])
        lvl_scores.append(scores[idx])
    return padded_multiclass_nms(torch.cat(lvl_boxes), torch.cat(lvl_scores),
                                 score_thr, nms_thr, max_per_img, nms_cfg)
