"""Loss primitives (port of vps_tpu/ops/losses.py: ``_reduce``,
``smooth_l1_loss``, ``softmax_cross_entropy``,
``binary_cross_entropy_with_logits``, ``sigmoid_focal_loss``, ``iou_loss``,
``accuracy``).

Every loss takes an explicit per-element ``weight`` and an ``avg_factor`` so
padded (invalid) slots contribute exactly zero, as in the JAX package. Class
scores are channel-last (``(..., C)``), the JAX layout. The MSE, balanced
L1, bounded and generalised IoU and GHM losses are not ported yet.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _reduce(loss, weight=None, avg_factor=None):
    if weight is not None:
        loss = loss * weight
    if avg_factor is None:
        return loss.sum()
    if not torch.is_tensor(avg_factor):
        avg_factor = torch.tensor(float(avg_factor), device=loss.device)
    return loss.sum() / avg_factor.clamp(min=1e-6)


def smooth_l1_loss(pred, target, beta=1.0, weight=None, avg_factor=None):
    diff = (pred - target).abs()
    loss = torch.where(diff < beta, 0.5 * diff * diff / beta, diff - 0.5 * beta)
    return _reduce(loss, weight, avg_factor)


def softmax_cross_entropy(logits, labels, weight=None, avg_factor=None,
                          ignore_index=None):
    """logits (..., C), integer labels (...)."""
    num_classes = logits.shape[-1]
    labels_safe = labels.long().clamp(0, num_classes - 1)
    logp = F.log_softmax(logits, dim=-1)
    loss = -logp.gather(-1, labels_safe[..., None])[..., 0]
    if ignore_index is not None:
        keep = (labels != ignore_index).to(loss.dtype)
        loss = loss * keep
        if avg_factor is None and weight is None:
            return loss.sum() / keep.sum().clamp(min=1.0)
    return _reduce(loss, weight, avg_factor)


def binary_cross_entropy_with_logits(logits, targets, weight=None,
                                     avg_factor=None):
    # numerically stable: max(x, 0) - x * t + log(1 + exp(-|x|))
    loss = (logits.clamp(min=0.0) - logits * targets
            + torch.log1p(torch.exp(-logits.abs())))
    return _reduce(loss, weight, avg_factor)


def sigmoid_focal_loss(logits, labels, gamma=2.0, alpha=0.25, weight=None,
                       avg_factor=None):
    """Per-anchor focal loss summed over the classes; ``labels`` are 1-based
    foreground ids, 0 the background (logits (N, C) hold the C foreground
    classes: class i is label i + 1)."""
    num_classes = logits.shape[-1]
    t = F.one_hot(labels.long(), num_classes + 1)[..., 1:].to(logits.dtype)
    p = torch.sigmoid(logits)
    pt = p * t + (1 - p) * (1 - t)
    at = alpha * t + (1 - alpha) * (1 - t)
    ce = (logits.clamp(min=0.0) - logits * t
          + torch.log1p(torch.exp(-logits.abs())))
    loss = (at * (1 - pt) ** gamma * ce).sum(-1)
    return _reduce(loss, weight, avg_factor)


def iou_loss(pred, target, eps=1e-6, weight=None, avg_factor=None):
    """-log(IoU) over aligned (x1, y1, x2, y2) boxes, the "+1" areas."""
    ix1 = torch.maximum(pred[..., 0], target[..., 0])
    iy1 = torch.maximum(pred[..., 1], target[..., 1])
    ix2 = torch.minimum(pred[..., 2], target[..., 2])
    iy2 = torch.minimum(pred[..., 3], target[..., 3])
    inter = (ix2 - ix1 + 1).clamp(min=0) * (iy2 - iy1 + 1).clamp(min=0)
    ap = ((pred[..., 2] - pred[..., 0] + 1).clamp(min=0)
          * (pred[..., 3] - pred[..., 1] + 1).clamp(min=0))
    at = ((target[..., 2] - target[..., 0] + 1).clamp(min=0)
          * (target[..., 3] - target[..., 1] + 1).clamp(min=0))
    ious = inter / (ap + at - inter).clamp(min=eps)
    loss = -torch.log(ious.clamp(eps, 1.0))
    return _reduce(loss, weight, avg_factor)


def accuracy(logits, labels, valid=None):
    correct = (logits.argmax(-1) == labels).float()
    if valid is not None:
        v = valid.float()
        return (correct * v).sum() / v.sum().clamp(min=1.0)
    return correct.mean()
