"""Fixed-size masked NMS (port of vps_tpu/ops/nms.py:nms).

Same algorithm and therefore the same survivors as the JAX fixpoint: scores
are sorted with a stable descending sort (ties keep index order), invalid
slots are masked to NEG_INF, and the greedy recursion "j is suppressed iff
some unsuppressed i < j overlaps it above the threshold" is solved by
iterating to the fixpoint over the upper-triangular adjacency matrix.
"""

from __future__ import annotations

import torch

from vps_torch.ops.box import bbox_overlaps

NEG_INF = -1e10


def top_k(x, k: int):
    """jax.lax.top_k semantics: descending, ties in index order."""
    vals, idx = torch.sort(x, descending=True, stable=True)
    return vals[:k], idx[:k]


def _suppression_fixpoint(adj):
    n = adj.shape[0]
    supp = adj.any(0)
    prev = torch.zeros_like(supp)
    it = 0
    while it < n and bool((supp != prev).any()):
        prev, supp = supp, (adj & ~supp[:, None]).any(0)
        it += 1
    return supp


def nms(boxes, scores, iou_thr: float, valid=None):
    """Greedy NMS. boxes (N, 4), scores (N,), valid (N,) bool or None.
    Returns keep (N,) bool in the original box order."""
    n = boxes.shape[0]
    if valid is None:
        valid = torch.ones(n, dtype=torch.bool, device=boxes.device)
    masked = torch.where(valid, scores, torch.full_like(scores, NEG_INF))
    order = torch.argsort(-masked, stable=True)
    b = boxes[order]
    v = valid[order]
    ious = bbox_overlaps(b, b)
    upper = torch.ones(n, n, dtype=torch.bool, device=boxes.device).triu(1)
    adj = (ious > iou_thr) & upper & v[:, None] & v[None, :]
    keep_sorted = v & ~_suppression_fixpoint(adj)
    keep = torch.zeros(n, dtype=torch.bool, device=boxes.device)
    keep[order] = keep_sorted
    return keep
