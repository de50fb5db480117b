"""Box heads (port of vps_tpu/models/bbox_head.py): SharedFCBBoxHead
(flattened RoI features -> shared FCs -> cls (C+1) and class-specific reg
(4(C+1)), or the C4 family's global-average-pooled window), and
get_det_bboxes (softmax, decode, multiclass NMS).
The first FC over a flattened window takes torch's (C, H, W) flattening, as
the mmdet weights do."""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from reference.vpsref.ops.box import delta2bbox
from reference.vpsref.ops.nms import multiclass_nms
from reference.vpsref.registry import HEADS


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
