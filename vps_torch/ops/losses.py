"""Loss primitives (port of vps_tpu/ops/losses.py: ``_reduce``,
``smooth_l1_loss``, ``softmax_cross_entropy``,
``binary_cross_entropy_with_logits``, ``sigmoid_focal_loss``, ``mse_loss``,
``balanced_l1_loss``, ``iou_loss``, ``bounded_iou_loss``, ``giou_loss``,
``ghm_c_loss``, ``ghm_r_loss``, ``accuracy``).

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


def _abs(x):
    """|x| with jnp.abs's gradient at 0 (1, where torch's abs gives 0)."""
    return torch.where(x >= 0, x, -x)


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


def mse_loss(pred, target, weight=None, avg_factor=None):
    return _reduce((pred - target) ** 2, weight, avg_factor)


def balanced_l1_loss(pred, target, beta=1.0, alpha=0.5, gamma=1.5,
                     weight=None, avg_factor=None):
    """Libra R-CNN's balanced L1: b makes the two branches meet smoothly at
    ``beta``."""
    diff = (pred - target).abs()
    b = math.e ** (gamma / alpha) - 1.0
    loss = torch.where(
        diff < beta,
        alpha / b * (b * diff + 1.0) * torch.log1p(b * diff / beta)
        - alpha * diff,
        gamma * diff + gamma / b - alpha * beta)
    return _reduce(loss, weight, avg_factor)


def bounded_iou_loss(pred, target, beta=0.2, eps=1e-3, weight=None,
                     avg_factor=None):
    """Bounded IoU loss ("Improving Localization Accuracy"): smooth L1 of
    the per-coordinate bounded IoU surrogates, the "+1" widths."""
    px = (pred[..., 0] + pred[..., 2]) * 0.5
    py = (pred[..., 1] + pred[..., 3]) * 0.5
    pw = pred[..., 2] - pred[..., 0] + 1.0
    ph = pred[..., 3] - pred[..., 1] + 1.0
    tx = (target[..., 0] + target[..., 2]) * 0.5
    ty = (target[..., 1] + target[..., 3]) * 0.5
    tw = target[..., 2] - target[..., 0] + 1.0
    th = target[..., 3] - target[..., 1] + 1.0
    # a centre on the target's has dx = 0: JAX's |dx| gradient there
    dx = _abs(tx - px)
    dy = _abs(ty - py)
    loss_dx = 1.0 - ((tw - 2.0 * dx) / (tw + 2.0 * dx + eps)).clamp(min=0.0)
    loss_dy = 1.0 - ((th - 2.0 * dy) / (th + 2.0 * dy + eps)).clamp(min=0.0)
    loss_dw = 1.0 - torch.minimum(tw / (pw + eps), pw / (tw + eps))
    loss_dh = 1.0 - torch.minimum(th / (ph + eps), ph / (th + eps))
    comb = torch.stack([loss_dx, loss_dy, loss_dw, loss_dh], -1)
    loss = torch.where(comb < beta, 0.5 * comb * comb / beta,
                       comb - 0.5 * beta).sum(-1)
    return _reduce(loss, weight, avg_factor)


def giou_loss(pred, target, eps=1e-7, weight=None, avg_factor=None):
    """1 - generalised IoU of aligned boxes, without the "+1"."""
    ix1 = torch.maximum(pred[..., 0], target[..., 0])
    iy1 = torch.maximum(pred[..., 1], target[..., 1])
    ix2 = torch.minimum(pred[..., 2], target[..., 2])
    iy2 = torch.minimum(pred[..., 3], target[..., 3])
    inter = (ix2 - ix1).clamp(min=0) * (iy2 - iy1).clamp(min=0)
    ap = ((pred[..., 2] - pred[..., 0]).clamp(min=0)
          * (pred[..., 3] - pred[..., 1]).clamp(min=0))
    at = ((target[..., 2] - target[..., 0]).clamp(min=0)
          * (target[..., 3] - target[..., 1]).clamp(min=0))
    union = ap + at - inter + eps
    iou = inter / union
    cx1 = torch.minimum(pred[..., 0], target[..., 0])
    cy1 = torch.minimum(pred[..., 1], target[..., 1])
    cx2 = torch.maximum(pred[..., 2], target[..., 2])
    cy2 = torch.maximum(pred[..., 3], target[..., 3])
    area_c = (cx2 - cx1).clamp(min=0) * (cy2 - cy1).clamp(min=0) + eps
    giou = iou - (area_c - union) / area_c
    return _reduce(1.0 - giou, weight, avg_factor)


def _ghm_edges(bins: int, last: float, device):
    """jnp.linspace(0, 1, bins + 1) in f32 (i * (1 / bins), the last edge
    1), its last edge raised by ``last``: a value on an edge falls in the
    same bin as in JAX."""
    step = torch.tensor(1.0, device=device) / bins
    edges = torch.cat([torch.arange(bins, dtype=torch.float32,
                                    device=device) * step,
                       torch.ones(1, device=device)])
    edges[-1] += last
    return edges


def _ghm_weights(g, in_bin, tot):
    """Inverse gradient density of each element from its bin membership
    ``in_bin`` (..., bins): a bin's count over ``tot`` times the number of
    non-empty bins."""
    counts = in_bin.sum(tuple(range(g.ndim)))
    density = torch.where(counts > 0, counts / tot * (counts > 0).sum(),
                          torch.ones_like(tot))
    return (in_bin / density.clamp(min=1e-12)).sum(-1)


def ghm_c_loss(logits, labels, valid=None, bins=10, momentum=0.0,
               weight=None):
    """Gradient Harmonizing classification loss (GHM-C): BCE re-weighted by
    the inverse density of |sigmoid(x) - t| over ``bins`` histogram bins.
    ``labels`` are 1-based foreground ids, 0 the background. The density is
    the batch's own (stateless); ``momentum`` and ``weight`` are accepted
    and unused, as in the JAX package."""
    num_classes = logits.shape[-1]
    t = F.one_hot(labels.long(), num_classes + 1)[..., 1:].to(logits.dtype)
    if valid is None:
        v = torch.ones(labels.shape, dtype=logits.dtype, device=logits.device)
    else:
        v = valid.to(logits.dtype)
    g = (torch.sigmoid(logits) - t).abs().detach()
    edges = _ghm_edges(bins, 1e-6, logits.device)
    in_bin = ((g[..., None] >= edges[:-1]) & (g[..., None] < edges[1:])
              & (v[..., None, None] > 0))
    tot = (v.sum() * num_classes).clamp(min=1.0)
    w = _ghm_weights(g, in_bin, tot)
    # at a logit of 0 (g = 0.5, an edge) the gradients of jnp.maximum
    # (half at the tie) and jnp.abs (1 at 0)
    ce = (torch.maximum(logits, torch.zeros_like(logits)) - logits * t
          + torch.log1p(torch.exp(-_abs(logits))))
    return (ce * w * v[..., None]).sum() / tot


def ghm_r_loss(pred, target, valid=None, mu=0.02, bins=10):
    """GHM-R: the ASL1 loss re-weighted by the inverse density of its
    gradient norm, the same histogram as ghm_c_loss."""
    diff = pred - target
    asl1 = torch.sqrt(diff * diff + mu * mu) - mu
    g = (diff / torch.sqrt(diff * diff + mu * mu)).abs().detach()
    if valid is None:
        v = torch.ones_like(pred)
    else:
        v = valid[..., None].expand(pred.shape).to(pred.dtype)
    edges = _ghm_edges(bins, 1e3, pred.device)
    in_bin = ((g[..., None] >= edges[:-1]) & (g[..., None] < edges[1:])
              & (v[..., None] > 0))
    tot = v.sum().clamp(min=1.0)
    w = _ghm_weights(g, in_bin, tot)
    return (asl1 * w * v).sum() / tot


def accuracy(logits, labels, valid=None):
    correct = (logits.argmax(-1) == labels).float()
    if valid is not None:
        v = valid.float()
        return (correct * v).sum() / v.sum().clamp(min=1.0)
    return correct.mean()
