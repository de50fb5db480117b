"""MaxIoU, approx-MaxIoU and point assignment (port of
vps_tpu/core/assigner.py: ``AssignResult``, ``max_iou_assign``, guided
anchoring's ``approx_max_iou_assign`` and RepPoints' ``point_assign``),
static shape and masked.

Semantics of mmdet's MaxIoUAssigner: -1 neutral, 0 negative, k + 1 assigned
to gt k, with the low-quality match step (gt_max_assign_all: ties go to the
later gt). Padded gts and boxes have their overlaps forced to 0, so they
never reach a threshold.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from vps_torch.ops.box import bbox_overlaps


class AssignResult(NamedTuple):
    assigned_gt_inds: torch.Tensor  # (N,) int: -1 neutral / 0 neg / k+1 pos
    max_overlaps: torch.Tensor  # (N,) float
    labels: Optional[torch.Tensor]  # (N,) gt label of the assignment (0 if none)
    pids: Optional[torch.Tensor]  # (N,) reference-frame pid (0 if none)


def max_iou_assign(bboxes, gt_bboxes, pos_iou_thr: float, neg_iou_thr: float,
                   min_pos_iou: float = 0.0, gt_labels=None, gt_pids=None,
                   bbox_valid=None, gt_valid=None,
                   gt_max_assign_all: bool = True) -> AssignResult:
    n, g = bboxes.shape[0], gt_bboxes.shape[0]
    bbox_valid, gt_valid = _valid(n, g, bbox_valid, gt_valid, bboxes.device)
    return _assign(bbox_overlaps(bboxes, gt_bboxes), bbox_valid, gt_valid,
                   pos_iou_thr, neg_iou_thr, min_pos_iou, gt_labels, gt_pids,
                   gt_max_assign_all)


def approx_max_iou_assign(approxs, gt_bboxes, pos_iou_thr: float,
                          neg_iou_thr: float, min_pos_iou: float = 0.0,
                          approxs_per_octave: int = 1, gt_labels=None,
                          bbox_valid=None, gt_valid=None) -> AssignResult:
    """ApproxMaxIoUAssigner (guided anchoring): each location owns
    ``approxs_per_octave`` approximate boxes, contiguous (location-major
    approxs (N * A, 4)), and is assigned by the largest overlap of its
    approxs, under MaxIoU's rules (the low-quality step on). ``bbox_valid``
    is (N,)."""
    n, g = approxs.shape[0] // approxs_per_octave, gt_bboxes.shape[0]
    bbox_valid, gt_valid = _valid(n, g, bbox_valid, gt_valid, approxs.device)
    overlaps = bbox_overlaps(approxs, gt_bboxes).reshape(
        n, approxs_per_octave, g).max(1).values
    return _assign(overlaps, bbox_valid, gt_valid, pos_iou_thr, neg_iou_thr,
                   min_pos_iou, gt_labels)


def _valid(n, g, bbox_valid, gt_valid, dev):
    if bbox_valid is None:
        bbox_valid = torch.ones(n, dtype=torch.bool, device=dev)
    if gt_valid is None:
        gt_valid = torch.ones(g, dtype=torch.bool, device=dev)
    return bbox_valid, gt_valid


def _assign(overlaps, bbox_valid, gt_valid, pos_iou_thr, neg_iou_thr,
            min_pos_iou, gt_labels=None, gt_pids=None,
            gt_max_assign_all: bool = True) -> AssignResult:
    """MaxIoU's rules on the (N, G) overlaps of the valid pairs."""
    n, g = overlaps.shape
    dev = overlaps.device
    pair_ok = bbox_valid[:, None] & gt_valid[None, :]
    overlaps = torch.where(pair_ok, overlaps, torch.zeros((), device=dev))
    max_overlaps, argmax_overlaps = overlaps.max(1)

    assigned = torch.full((n,), -1, dtype=torch.long, device=dev)
    # negatives, then positives above the threshold
    assigned = torch.where((max_overlaps >= 0) & (max_overlaps < neg_iou_thr),
                           torch.zeros_like(assigned), assigned)
    assigned = torch.where(max_overlaps >= pos_iou_thr, argmax_overlaps + 1,
                           assigned)
    # low-quality matches: each gt claims its best-overlap boxes
    gt_max = overlaps.max(0).values
    claim = ((overlaps == gt_max[None, :]) & (gt_max[None, :] >= min_pos_iou)
             & pair_ok & (overlaps > 0))
    if gt_max_assign_all:
        # the later gt wins, as the reference's ascending loop overwrites
        last_gt = g - 1 - claim.flip(1).int().argmax(1)
        assigned = torch.where(claim.any(1), last_gt + 1, assigned)
    assigned = torch.where(bbox_valid, assigned, torch.full_like(assigned, -1))

    pos = assigned > 0
    gt_idx = (assigned - 1).clamp(0, g - 1)
    labels = pids = None
    if gt_labels is not None:
        labels = torch.where(pos, gt_labels[gt_idx], torch.zeros_like(gt_idx))
    if gt_pids is not None:
        pids = torch.where(pos, gt_pids[gt_idx], torch.zeros_like(gt_idx))
    return AssignResult(assigned, max_overlaps, labels, pids)


def point_assign(points, gt_bboxes, scale: float = 4.0, pos_num: int = 3,
                 gt_labels=None, gt_valid=None) -> AssignResult:
    """RepPoints' PointAssigner: points (N, 3) = (x, y, stride); each valid
    gt claims its ``pos_num`` nearest points (distance from the gt's centre
    in units of its width and height) on the level its size maps to; a
    point claimed by several gts goes to the last. A point's rank for a gt
    is the number of points strictly closer, as JAX's (N, N, G) comparison
    counts it, here from each gt's sorted distances (``searchsorted`` on
    the left), so memory stays O(N G). Ties share a rank; points off the
    gt's level have infinite distance and are never claimed."""
    g = gt_bboxes.shape[0]
    dev = points.device
    if gt_valid is None:
        gt_valid = torch.ones(g, dtype=torch.bool, device=dev)
    px, py, stride = points[:, 0], points[:, 1], points[:, 2]
    plvl = torch.log2(stride.clamp(min=1.0))
    cx = (gt_bboxes[:, 0] + gt_bboxes[:, 2]) * 0.5
    cy = (gt_bboxes[:, 1] + gt_bboxes[:, 3]) * 0.5
    gw = (gt_bboxes[:, 2] - gt_bboxes[:, 0]).clamp(min=1e-6)
    gh = (gt_bboxes[:, 3] - gt_bboxes[:, 1]).clamp(min=1e-6)
    # gt level: log2 of sqrt(area) / scale, clipped to the points' levels
    glvl = torch.floor(torch.log2(torch.sqrt(gw * gh) / scale + 1e-12))
    glvl = torch.minimum(torch.maximum(glvl, plvl.min()), plvl.max())
    same_lvl = (plvl[:, None] - glvl[None, :]).abs() < 0.5  # (N, G)
    dist = torch.sqrt(((px[:, None] - cx[None, :]) / gw[None, :]) ** 2
                      + ((py[:, None] - cy[None, :]) / gh[None, :]) ** 2)
    dist = torch.where(same_lvl & gt_valid[None, :], dist,
                       torch.full_like(dist, float("inf")))
    cols = dist.t().contiguous()  # (G, N)
    rank = torch.searchsorted(cols.sort(-1).values, cols, side="left").t()
    claim = (rank < pos_num) & torch.isfinite(dist)
    last_gt = g - 1 - claim.flip(1).int().argmax(1)
    assigned = torch.where(claim.any(1), last_gt + 1,
                           torch.zeros_like(last_gt))
    pos = assigned > 0
    gt_idx = (assigned - 1).clamp(0, g - 1)
    labels = None
    if gt_labels is not None:
        labels = torch.where(pos, gt_labels[gt_idx], torch.zeros_like(gt_idx))
    return AssignResult(assigned, dist.min(1).values, labels, None)
