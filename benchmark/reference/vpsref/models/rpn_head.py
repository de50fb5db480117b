"""RPN head and proposal decoding (port of vps_tpu/models/rpn_head.py)."""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from reference.vpsref.models.layers import Conv
from reference.vpsref.ops.box import delta2bbox
from reference.vpsref.ops.nms import NEG_INF, nms, top_k


class RPNHead(nn.Module):
    """3x3 conv + ReLU, 1x1 cls (A channels) and 1x1 reg (4A channels)."""

    def __init__(self, in_channels=256, feat_channels=256, num_anchors=3,
                 device=None):
        super().__init__()
        self.rpn_conv = Conv(in_channels, feat_channels, 3, 1, 1, device=device)
        self.rpn_cls = Conv(feat_channels, num_anchors, 1, 1, 0, device=device)
        self.rpn_reg = Conv(feat_channels, num_anchors * 4, 1, 1, 0,
                            device=device)

    def forward(self, feats):
        """feats: list of (B, C, H, W) -> per-level cls (B, A, H, W) and reg
        (B, 4A, H, W)."""
        cls_outs, reg_outs = [], []
        for f in feats:
            h = F.relu(self.rpn_conv(f))
            cls_outs.append(self.rpn_cls(h))
            reg_outs.append(self.rpn_reg(h))
        return cls_outs, reg_outs


def rpn_proposals(cls_outs, reg_outs, anchors_per_level, img_shape,
                  nms_pre: int = 2000, nms_thr: float = 0.7,
                  max_num: int = 2000):
    """Fixed-capacity proposals of ONE image (mmdet 1.x get_bboxes with
    nms_across_levels=False). cls_outs / reg_outs: per-level (H, W, A) /
    (H, W, 4A), as in JAX; anchors_per_level: (H*W*A, 4). Returns
    (proposals (max_num, 4), scores (max_num,), valid (max_num,))."""
    all_boxes, all_scores = [], []
    for cls, reg, anchors in zip(cls_outs, reg_outs, anchors_per_level):
        scores = torch.sigmoid(cls.reshape(-1))
        deltas = reg.reshape(-1, 4)
        k = min(nms_pre, scores.shape[0])
        top_scores, top_idx = top_k(scores, k)
        boxes = delta2bbox(anchors[top_idx], deltas[top_idx], max_shape=img_shape)
        keep = nms(boxes, top_scores, nms_thr)
        all_boxes.append(boxes)
        all_scores.append(torch.where(keep, top_scores,
                                      torch.full_like(top_scores, NEG_INF)))
    boxes = torch.cat(all_boxes, 0)
    scores = torch.cat(all_scores, 0)
    k = min(max_num, scores.shape[0])
    top_scores, top_idx = top_k(scores, k)
    proposals = boxes[top_idx]
    valid = top_scores > NEG_INF / 2
    if k < max_num:
        pad = max_num - k
        proposals = F.pad(proposals, (0, 0, 0, pad))
        top_scores = F.pad(top_scores, (0, pad), value=NEG_INF)
        valid = F.pad(valid, (0, pad))
    proposals = torch.where(valid[:, None], proposals,
                            torch.zeros_like(proposals))
    return proposals, top_scores.clamp(min=0.0), valid
