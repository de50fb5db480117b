"""Loss primitives (port of vps_tpu/ops/losses.py: ``_reduce``,
``smooth_l1_loss``, ``softmax_cross_entropy``,
``binary_cross_entropy_with_logits``, ``accuracy``).

Every loss takes an explicit per-element ``weight`` and an ``avg_factor`` so
padded (invalid) slots contribute exactly zero, as in the JAX package. Class
scores are channel-last (``(..., C)``), the JAX layout. Gradients are
autograd through these expressions, as JAX differentiates its own.
"""

from __future__ import annotations

import math

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


def accuracy(logits, labels, valid=None):
    correct = (logits.argmax(-1) == labels).float()
    if valid is not None:
        v = valid.float()
        return (correct * v).sum() / v.sum().clamp(min=1.0)
    return correct.mean()
