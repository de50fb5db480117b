"""Box coding and geometry (port of vps_tpu/ops/box.py): the legacy mmdet
conventions (+1 widths, -/+0.5 decoded corners), same operation order as the
JAX functions so float results agree."""

from __future__ import annotations

import math

import torch


def bbox2delta(proposals, gt, means=(0.0, 0.0, 0.0, 0.0),
               stds=(1.0, 1.0, 1.0, 1.0)):
    """Encode gt boxes relative to proposals, (..., 4) -> (..., 4) f32."""
    proposals = proposals.float()
    gt = gt.float()
    px = (proposals[..., 0] + proposals[..., 2]) * 0.5
    py = (proposals[..., 1] + proposals[..., 3]) * 0.5
    pw = proposals[..., 2] - proposals[..., 0] + 1.0
    ph = proposals[..., 3] - proposals[..., 1] + 1.0
    gx = (gt[..., 0] + gt[..., 2]) * 0.5
    gy = (gt[..., 1] + gt[..., 3]) * 0.5
    gw = gt[..., 2] - gt[..., 0] + 1.0
    gh = gt[..., 3] - gt[..., 1] + 1.0
    deltas = torch.stack([(gx - px) / pw, (gy - py) / ph,
                          torch.log(gw / pw), torch.log(gh / ph)], dim=-1)
    means = torch.tensor(means, dtype=torch.float32, device=deltas.device)
    stds = torch.tensor(stds, dtype=torch.float32, device=deltas.device)
    return (deltas - means) / stds


def delta2bbox(rois, deltas, max_shape=None, means=None, stds=None,
               wh_ratio_clip: float = 16 / 1000):
    """rois (N, 4), deltas (N, 4K) -> boxes (N, 4K). ``means`` / ``stds``
    (4 each) denormalise the deltas first, deltas * stds + means, as the
    R-CNN heads' targets were coded; None (the RPN's 0 and 1) uses them as
    they are. dw and dh are clipped to |log(wh_ratio_clip)| (guided
    anchoring decodes its shapes with 1e-6)."""
    if means is not None or stds is not None:
        k = deltas.shape[-1] // 4
        m = torch.tensor(tuple(means or (0.0,) * 4), dtype=torch.float32,
                         device=deltas.device).repeat(k)
        s = torch.tensor(tuple(stds or (1.0,) * 4), dtype=torch.float32,
                         device=deltas.device).repeat(k)
        deltas = deltas * s + m
    dx = deltas[..., 0::4]
    dy = deltas[..., 1::4]
    dw = deltas[..., 2::4]
    dh = deltas[..., 3::4]
    max_ratio = abs(math.log(wh_ratio_clip))
    dw = dw.clamp(-max_ratio, max_ratio)
    dh = dh.clamp(-max_ratio, max_ratio)
    px = ((rois[..., 0] + rois[..., 2]) * 0.5)[..., None]
    py = ((rois[..., 1] + rois[..., 3]) * 0.5)[..., None]
    pw = (rois[..., 2] - rois[..., 0] + 1.0)[..., None]
    ph = (rois[..., 3] - rois[..., 1] + 1.0)[..., None]
    gw = pw * torch.exp(dw)
    gh = ph * torch.exp(dh)
    gx = px + pw * dx
    gy = py + ph * dy
    x1 = gx - gw * 0.5 + 0.5
    y1 = gy - gh * 0.5 + 0.5
    x2 = gx + gw * 0.5 - 0.5
    y2 = gy + gh * 0.5 - 0.5
    if max_shape is not None:
        x1 = x1.clamp(0, max_shape[1] - 1)
        y1 = y1.clamp(0, max_shape[0] - 1)
        x2 = x2.clamp(0, max_shape[1] - 1)
        y2 = y2.clamp(0, max_shape[0] - 1)
    return torch.stack([x1, y1, x2, y2], dim=-1).reshape(deltas.shape)


def bbox_area(boxes):
    return (boxes[..., 2] - boxes[..., 0] + 1.0) * (boxes[..., 3] - boxes[..., 1] + 1.0)


def bbox_overlaps(boxes1, boxes2):
    """Pairwise IoU with the legacy +1 widths, (..., M, 4) x (..., N, 4) ->
    (..., M, N), one coordinate at a time (no (..., M, N, 2) temporaries)."""
    a = boxes1[..., :, None, :]
    b = boxes2[..., None, :, :]
    iw = (torch.minimum(a[..., 2], b[..., 2])
          - torch.maximum(a[..., 0], b[..., 0]) + 1.0).clamp(min=0)
    ih = (torch.minimum(a[..., 3], b[..., 3])
          - torch.maximum(a[..., 1], b[..., 1]) + 1.0).clamp(min=0)
    overlap = iw * ih
    area1 = bbox_area(boxes1)[..., :, None]
    area2 = bbox_area(boxes2)[..., None, :]
    union = area1 + area2 - overlap
    return overlap / union.clamp(min=1e-6)


