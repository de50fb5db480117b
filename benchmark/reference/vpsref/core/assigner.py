"""MaxIoU assignment (port of vps_tpu/core/assigner.py: ``AssignResult`` and
``max_iou_assign``), static shape and masked.

Semantics of mmdet's MaxIoUAssigner: -1 neutral, 0 negative, k + 1 assigned
to gt k, with the low-quality match step (gt_max_assign_all: ties go to the
later gt). Padded gts and boxes have their overlaps forced to 0, so they
never reach a threshold.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from reference.vpsref.ops.box import bbox_overlaps


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


