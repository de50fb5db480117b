"""Fixed-size masked NMS (port of vps_tpu/ops/nms.py: nms and
multiclass_nms).

Same algorithm and therefore the same survivors as the JAX fixpoint: scores
are sorted with a stable descending sort (ties keep index order), invalid
slots are masked to NEG_INF, and the greedy recursion "j is suppressed iff
some unsuppressed i < j overlaps it above the threshold" is solved by
iterating to the fixpoint over the upper-triangular adjacency matrix.

JAX vmaps one NMS per class; here the classes run in one batched fixpoint
(one (C-1, N, N) adjacency; in groups when that exceeds ``PAIR_BUDGET``
pairs), so a call makes as many host syncs as the longest suppression
chain of any class (of each group), not one loop per class.
"""

from __future__ import annotations

import torch

from reference.vpsref.ops.box import bbox_overlaps

NEG_INF = -1e10
# multiclass_nms's most (class, box, box) pairs at once: 2^28, 1 GiB a f32
# temporary
PAIR_BUDGET = 1 << 28

# host syncs made by the fixpoint loops (one ``bool()`` an iteration), for
# the callers that count them (tests, chip_smoke.py)
fixpoint_syncs = 0


def top_k(x, k: int):
    """jax.lax.top_k semantics: descending, ties in index order."""
    vals, idx = torch.sort(x, descending=True, stable=True)
    return vals[:k], idx[:k]


def _suppression_fixpoint(adj):
    """adj (..., N, N) bool, adj[..., i, j] iff i < j in score order and
    IoU > thr. Returns supp (..., N): j is suppressed iff some unsuppressed
    i overlaps it; iterated from supp = 0 to the fixpoint, every leading
    index at once."""
    global fixpoint_syncs
    n = adj.shape[-1]
    supp = adj.any(-2)
    prev = torch.zeros_like(supp)
    it = 0
    while it < n:
        fixpoint_syncs += 1
        if not bool((supp != prev).any()):
            break
        prev, supp = supp, (adj & ~supp[..., :, None]).any(-2)
        it += 1
    return supp


def _nms_keep(boxes, scores, iou_thr: float, valid):
    """Greedy NMS of each set along the leading dims: boxes (..., N, 4),
    scores and valid (..., N). Returns keep (..., N) in the input order."""
    n = boxes.shape[-2]
    masked = torch.where(valid, scores, torch.full_like(scores, NEG_INF))
    order = torch.argsort(-masked, dim=-1, stable=True)
    b = boxes.gather(-2, order[..., None].expand(*order.shape, 4))
    v = valid.gather(-1, order)
    upper = torch.ones(n, n, dtype=torch.bool, device=boxes.device).triu(1)
    adj = ((bbox_overlaps(b, b) > iou_thr) & upper & v[..., :, None]
           & v[..., None, :])
    keep_sorted = v & ~_suppression_fixpoint(adj)
    return torch.zeros_like(keep_sorted).scatter(-1, order, keep_sorted)


def nms(boxes, scores, iou_thr: float, valid=None):
    """Greedy NMS. boxes (N, 4), scores (N,), valid (N,) bool or None.
    Returns keep (N,) bool in the original box order."""
    if valid is None:
        valid = torch.ones(boxes.shape[0], dtype=torch.bool, device=boxes.device)
    return _nms_keep(boxes, scores, iou_thr, valid)


def multiclass_nms(multi_bboxes, multi_scores, score_thr: float,
                   iou_thr: float, max_num: int, score_factors=None,
                   nms_cfg=None):
    """Per-class NMS over softmax scores, fixed-capacity output.

    multi_bboxes (N, 4) or (N, C*4) class-specific boxes; multi_scores (N, C)
    with class 0 = background (skipped). ``nms_cfg``: ``dict(type='nms' |
    'soft_nms', iou_thr=..., [min_score, sigma, method])``; it overrides
    ``iou_thr``, and soft-NMS selects by the decayed scores.

    Returns (dets (max_num, 5) rows (x1, y1, x2, y2, score) by score
    descending, labels (max_num,) 0-based, valid (max_num,))."""
    nms_cfg = dict(nms_cfg or {})
    nms_type = nms_cfg.get("type", "nms")
    iou_thr = nms_cfg.get("iou_thr", iou_thr)
    n, num_classes = multi_scores.shape
    nc = num_classes - 1  # foreground classes

    # class-major (C-1, N, ...): one set of boxes a class
    if multi_bboxes.shape[-1] == 4:
        boxes_c = multi_bboxes[None].expand(nc, n, 4)
    else:
        boxes_c = multi_bboxes.reshape(n, num_classes, 4)[:, 1:].transpose(0, 1)
    scores_c = multi_scores[:, 1:].t()
    if score_factors is not None:
        scores_c = scores_c * score_factors[None, :]
    valid_c = scores_c > score_thr

    if nms_type != "nms":
        raise ValueError(f"unknown nms type {nms_type!r}")
    # the classes in groups of at most PAIR_BUDGET (class, box, box) pairs:
    # one group for the R-CNNs' 80 x 1000 boxes, several for a
    # single-stage head's ~5000 candidates
    step = max(1, PAIR_BUDGET // (n * n))
    keep_c = torch.cat([
        _nms_keep(boxes_c[c0:c0 + step], scores_c[c0:c0 + step], iou_thr,
                  valid_c[c0:c0 + step]) for c0 in range(0, nc, step)])

    # flattened proposal-major, as JAX's (N, C-1) layout: ties in top_k
    # break by proposal, then class
    flat_boxes = boxes_c.transpose(0, 1).reshape(-1, 4)
    flat_scores = scores_c.t().reshape(-1)
    flat_keep = keep_c.t().reshape(-1)
    masked = torch.where(flat_keep, flat_scores,
                         torch.full_like(flat_scores, NEG_INF))
    top_scores, top_idx = top_k(masked, max_num)
    valid = top_scores > NEG_INF / 2
    dets = torch.cat([flat_boxes[top_idx], top_scores.clamp(min=0.0)[:, None]],
                     -1)
    dets = torch.where(valid[:, None], dets, torch.zeros_like(dets))
    labels = torch.where(valid, top_idx % nc, torch.zeros_like(top_idx))
    return dets, labels, valid
