"""Box heads (port of vps_tpu/models/bbox_head.py): SharedFCBBoxHead
(flattened RoI features -> shared FCs -> cls (C+1) and class-specific reg
(4(C+1)), or the C4 family's global-average-pooled window), Double-Head
R-CNN's DoubleConvFCBBoxHead, and the decode functions regress_by_class
(cascade refinement) and get_det_bboxes (softmax, decode, multiclass NMS).
The first FC over a flattened window takes torch's (C, H, W) flattening, as
the mmdet weights do."""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from vps_torch.models.layers import Conv, FrozenBatchNorm
from vps_torch.models.resnet import Bottleneck
from vps_torch.ops.box import delta2bbox
from vps_torch.ops.nms import multiclass_nms
from vps_torch.registry import HEADS


@HEADS.register
class SharedFCBBoxHead(nn.Module):
    """``with_avg_pool``: global-average the RoI window before the FCs (the
    C4 / shared-ResLayer detectors); ``num_fcs = 0`` feeds the classifier
    the window itself."""

    def __init__(self, num_fcs=2, in_channels=256, fc_out_channels=1024,
                 roi_feat_size=7, num_classes=9, reg_class_agnostic=False,
                 device=None,
                 target_means: Sequence[float] = (0.0, 0.0, 0.0, 0.0),
                 target_stds: Sequence[float] = (0.1, 0.1, 0.2, 0.2),
                 with_avg_pool: bool = False):
        super().__init__()
        in_dim = in_channels if with_avg_pool else \
            in_channels * roi_feat_size * roi_feat_size
        dims = [in_dim] + [fc_out_channels] * num_fcs
        self.shared_fcs = nn.ModuleList(
            nn.Linear(dims[i], dims[i + 1], device=device)
            for i in range(num_fcs))
        self.num_classes = num_classes
        self.reg_class_agnostic = reg_class_agnostic
        self.target_means = tuple(target_means)
        self.target_stds = tuple(target_stds)
        self.with_avg_pool = with_avg_pool
        self.fc_cls = nn.Linear(dims[-1], num_classes, device=device)
        reg_dim = 4 if reg_class_agnostic else 4 * num_classes
        self.fc_reg = nn.Linear(dims[-1], reg_dim, device=device)

    def forward(self, roi_feats):
        """roi_feats (R, S, S, C) -> (cls logits (R, K), deltas (R, 4K) or
        (R, 4) class-agnostic)."""
        if self.with_avg_pool:
            x = roi_feats.mean(dim=(1, 2))
        else:
            x = roi_feats.permute(0, 3, 1, 2).reshape(roi_feats.shape[0], -1)
        for fc in self.shared_fcs:
            x = F.relu(fc(x))
        return self.fc_cls(x), self.fc_reg(x)


class _ConvBN(nn.Module):
    """conv -> frozen BN (mmdet ConvModule naming: ``conv``, ``bn``)."""

    def __init__(self, cin, cout, k, padding, bias, device=None):
        super().__init__()
        self.conv = Conv(cin, cout, k, 1, padding, bias=bias, device=device)
        self.bn = FrozenBatchNorm(cout, device=device)

    def forward(self, x):
        return self.bn(self.conv(x))


class BasicResBlock(nn.Module):
    """Double-Head's residual block (mmdet double_bbox_head.py): 3x3 + 1x1
    conv against a 1x1 identity projection. The projection keeps the bias
    that vps_tpu gives it (mmdet's has none, as a conv before BN needs
    none): ``res_block.conv_identity.conv.bias``."""

    def __init__(self, in_channels, out_channels, device=None):
        super().__init__()
        self.conv1 = _ConvBN(in_channels, in_channels, 3, 1, False, device)
        self.conv2 = _ConvBN(in_channels, out_channels, 1, 0, False, device)
        self.conv_identity = _ConvBN(in_channels, out_channels, 1, 0, True,
                                     device)

    def forward(self, x):
        h = self.conv2(F.relu(self.conv1(x)))
        return F.relu(h + self.conv_identity(x))


@HEADS.register
class DoubleConvFCBBoxHead(nn.Module):
    """Double-Head R-CNN box head: the reg branch is a BasicResBlock +
    ``num_convs`` Bottlenecks + global average pool -> fc_reg; the cls branch
    ``num_fcs`` FCs on the flattened window -> fc_cls. Called with the two
    windows the detector pools (cls at scale 1, reg at
    reg_roi_scale_factor)."""

    def __init__(self, num_convs=1, num_fcs=1, in_channels=256,
                 conv_out_channels=1024, fc_out_channels=1024, roi_feat_size=7,
                 num_classes=9,
                 target_means: Sequence[float] = (0.0, 0.0, 0.0, 0.0),
                 target_stds: Sequence[float] = (0.1, 0.1, 0.2, 0.2),
                 reg_class_agnostic=False, device=None):
        super().__init__()
        self.num_classes = num_classes
        self.reg_class_agnostic = reg_class_agnostic
        self.target_means = tuple(target_means)
        self.target_stds = tuple(target_stds)
        self.res_block = BasicResBlock(in_channels, conv_out_channels, device)
        self.conv_branch = nn.ModuleList(
            Bottleneck(conv_out_channels, conv_out_channels // 4,
                       device=device) for _ in range(num_convs))
        dims = [in_channels * roi_feat_size * roi_feat_size] + \
            [fc_out_channels] * num_fcs
        self.fc_branch = nn.ModuleList(
            nn.Linear(dims[i], dims[i + 1], device=device)
            for i in range(num_fcs))
        reg_dim = 4 if reg_class_agnostic else 4 * num_classes
        self.fc_reg = nn.Linear(conv_out_channels, reg_dim, device=device)
        self.fc_cls = nn.Linear(dims[-1], num_classes, device=device)

    def forward(self, x_cls, x_reg):
        """x_cls, x_reg (R, S, S, C) -> (cls logits (R, K), deltas)."""
        h = self.res_block(x_reg.permute(0, 3, 1, 2))
        for block in self.conv_branch:
            h = block(h)
        reg = self.fc_reg(h.mean(dim=(2, 3)))
        f = x_cls.permute(0, 3, 1, 2).reshape(x_cls.shape[0], -1)
        for fc in self.fc_branch:
            f = F.relu(fc(f))
        return self.fc_cls(f), reg


def regress_by_class(rois, labels, bbox_pred, img_shape,
                     target_means=(0.0, 0.0, 0.0, 0.0),
                     target_stds=(0.1, 0.1, 0.2, 0.2),
                     reg_class_agnostic: bool = False):
    """Cascade refinement: each RoI's 4 deltas of its (1-based fg) label,
    decoded and clipped to the image. Label 0 picks the background deltas;
    callers keep such rows invalid."""
    if not reg_class_agnostic:
        nc = bbox_pred.shape[-1] // 4
        bbox_pred = bbox_pred.reshape(-1, nc, 4).gather(
            1, labels.long()[:, None, None].expand(-1, 1, 4))[:, 0]
    return delta2bbox(rois, bbox_pred, max_shape=img_shape,
                      means=target_means, stds=target_stds)


def get_det_bboxes(rois, cls_logits, bbox_deltas, img_shape, score_thr: float,
                   nms_iou_thr: float, max_per_img: int,
                   target_means=(0.0, 0.0, 0.0, 0.0),
                   target_stds=(0.1, 0.1, 0.2, 0.2), valid=None, nms_cfg=None):
    """mmdet 1.x BBoxHead.get_det_bboxes: softmax scores (zeroed on invalid
    RoIs) -> delta decode clipped to the image -> multiclass NMS. Returns
    (dets (max_per_img, 5), labels 0-based, valid)."""
    scores = torch.softmax(cls_logits, -1)
    if valid is not None:
        scores = scores * valid[:, None]
    boxes = delta2bbox(rois, bbox_deltas, max_shape=img_shape,
                       means=target_means, stds=target_stds)
    return multiclass_nms(boxes, scores, score_thr, nms_iou_thr, max_per_img,
                          nms_cfg=nms_cfg)
