"""Training targets (port of vps_tpu/core/targets.py: ``assign_from_cfg``,
``sample_from_cfg``, ``anchor_target`` and ``proposal_target``): mmdet's
anchor_target, bbox_target / bbox_id_target and mask_target for ONE image,
static shape. The detector calls them per sample."""

from __future__ import annotations

from typing import NamedTuple

import torch

from vps_torch.core.assigner import AssignResult, max_iou_assign
from vps_torch.core.sampler import (
    SampleResult,
    combined_sample,
    instance_balanced_sample,
    iou_balanced_neg_sample,
    ohem_sample,
    pseudo_sample,
    random_sample,
)
from vps_torch.ops.box import bbox2delta
from vps_torch.ops.mask import crop_and_resize_indexed


def assign_from_cfg(cfg, bboxes, gt_bboxes, gt_labels=None, gt_pids=None,
                    bbox_valid=None, gt_valid=None) -> AssignResult:
    """``type=`` dispatch over assigners; MaxIoUAssigner, the only one the
    two-stage and cascade detectors use, is the only one ported."""
    typ = cfg.get("type", "MaxIoUAssigner")
    if typ != "MaxIoUAssigner":
        raise KeyError(f"assigner type {typ!r} is not ported (ROADMAP.md "
                       "queue 1 item 5 (c): the single-stage family)")
    return max_iou_assign(
        bboxes, gt_bboxes, pos_iou_thr=cfg["pos_iou_thr"],
        neg_iou_thr=cfg["neg_iou_thr"], min_pos_iou=cfg.get("min_pos_iou", 0.0),
        gt_labels=gt_labels, gt_pids=gt_pids, bbox_valid=bbox_valid,
        gt_valid=gt_valid, gt_max_assign_all=cfg.get("gt_max_assign_all", True))


def sample_from_cfg(generator, cfg, assign: AssignResult,
                    loss_fn=None) -> SampleResult:
    """``type=`` dispatch over the six samplers, with vps_tpu's arguments.
    ``loss_fn``: OHEM's per-candidate loss, called as loss_fn(assign) ->
    (N,)."""
    typ = cfg.get("type", "RandomSampler")
    num, pf = cfg["num"], cfg["pos_fraction"]
    gi = assign.assigned_gt_inds
    if typ == "RandomSampler":
        return random_sample(generator, gi, num, pf)
    if typ == "PseudoSampler":
        return pseudo_sample(gi, num)
    if typ == "OHEMSampler":
        if loss_fn is None:
            raise ValueError("OHEMSampler needs a hard-mining loss_fn (the "
                             "detector passes its bbox head's forward)")
        return ohem_sample(gi, loss_fn(assign), num, pf)
    if typ == "InstanceBalancedPosSampler":
        return instance_balanced_sample(generator, gi, num, pf)
    if typ == "IoUBalancedNegSampler":
        return iou_balanced_neg_sample(
            generator, gi, assign.max_overlaps, num, pf,
            floor_thr=cfg.get("floor_thr", -1.0),
            floor_fraction=cfg.get("floor_fraction", 0.0),
            num_bins=cfg.get("num_bins", 3))
    if typ == "CombinedSampler":
        return combined_sample(generator, gi, assign.max_overlaps, num, pf)
    raise KeyError(f"unknown sampler type {typ!r}")


def _scatter(n, idx, values):
    """Rows ``values`` put at ``idx`` of an (n, ...) zero array; an index of
    n drops its row."""
    out = values.new_zeros((n + 1,) + values.shape[1:])
    return out.index_copy(0, idx, values)[:n]


class AnchorTargets(NamedTuple):
    labels: torch.Tensor  # (N,) {0, 1} for the RPN
    label_weights: torch.Tensor  # (N,)
    bbox_targets: torch.Tensor  # (N, 4)
    bbox_weights: torch.Tensor  # (N, 4)
    num_pos: torch.Tensor
    num_neg: torch.Tensor


def anchor_target(generator, flat_anchors, valid_flags, gt_bboxes, gt_valid,
                  img_shape, cfg, target_means=(0.0, 0.0, 0.0, 0.0),
                  target_stds=(1.0, 1.0, 1.0, 1.0)) -> AnchorTargets:
    """RPN targets for ONE image over the flattened anchors of all levels.
    cfg: assigner, sampler and allowed_border; img_shape: (H, W) of the
    input used for the border filter (anchor_inside_flags)."""
    n = flat_anchors.shape[0]
    border = cfg["allowed_border"]
    h, w = img_shape
    inside = (valid_flags & (flat_anchors[:, 0] >= -border)
              & (flat_anchors[:, 1] >= -border)
              & (flat_anchors[:, 2] < w + border)
              & (flat_anchors[:, 3] < h + border))
    assign = assign_from_cfg(cfg["assigner"], flat_anchors, gt_bboxes,
                             bbox_valid=inside, gt_valid=gt_valid)
    sample = sample_from_cfg(generator, cfg["sampler"], assign)
    inds, pos, valid = sample.inds, sample.pos_mask, sample.valid
    gt_idx = (assign.assigned_gt_inds[inds] - 1).clamp(0, gt_bboxes.shape[0] - 1)
    deltas = bbox2delta(flat_anchors[inds], gt_bboxes[gt_idx], target_means,
                        target_stds)
    # sampled slots scattered back to the anchors (invalid slots dropped)
    idx = torch.where(valid, inds, torch.full_like(inds, n))
    posf = pos.float()
    return AnchorTargets(
        _scatter(n, idx, pos.long()), _scatter(n, idx, valid.float()),
        _scatter(n, idx, deltas * posf[:, None]),
        _scatter(n, idx, posf[:, None].expand(-1, 4).contiguous()),
        sample.num_pos, sample.num_neg)


class SampledRois(NamedTuple):
    rois: torch.Tensor  # (num, 4)
    labels: torch.Tensor  # (num,) 1-based fg label, 0 for negatives
    label_weights: torch.Tensor  # (num,)
    bbox_targets: torch.Tensor  # (num, 4)
    bbox_weights: torch.Tensor  # (num, 4)
    ids: torch.Tensor  # (num,) tracking target column (0 = new object)
    id_weights: torch.Tensor  # (num,)
    pos_mask: torch.Tensor  # (num,) positives-first prefix
    valid: torch.Tensor  # (num,)
    pos_gt_idx: torch.Tensor  # (num,) index of the matched gt (clipped)
    mask_targets: torch.Tensor  # (num_pos_max, mask_size, mask_size)
    num_pos: torch.Tensor
    num_neg: torch.Tensor
    from_gt: torch.Tensor  # (num,) the row came from the appended gt boxes


def proposal_target(generator, proposals, proposal_valid, gt_bboxes,
                    gt_labels, gt_valid, cfg, gt_pids=None, gt_masks=None,
                    target_means=(0.0, 0.0, 0.0, 0.0),
                    target_stds=(0.1, 0.1, 0.2, 0.2),
                    loss_fn=None) -> SampledRois:
    """RCNN sampling and targets for ONE image: gt boxes appended to the
    proposals (add_gt_as_proposals), assign, sample, bbox targets, the
    pid -> id targets of bbox_id_target and the 28x28 mask targets of the
    positive prefix. ``loss_fn`` (OHEMSampler only): loss_fn(cand_boxes,
    cand_valid, assign) -> (N,) hard-mining losses of the candidates."""
    cand = torch.cat([proposals, gt_bboxes], 0)
    cand_valid = torch.cat([proposal_valid, gt_valid], 0)
    assign = assign_from_cfg(cfg["assigner"], cand, gt_bboxes,
                             gt_labels=gt_labels, gt_pids=gt_pids,
                             bbox_valid=cand_valid, gt_valid=gt_valid)
    s = cfg["sampler"]
    num = s["num"]
    ohem_loss_fn = None
    if loss_fn is not None:
        def ohem_loss_fn(a):
            return loss_fn(cand, cand_valid, a)
    sample = sample_from_cfg(generator, s, assign, loss_fn=ohem_loss_fn)
    inds, pos, valid = sample.inds, sample.pos_mask, sample.valid
    rois = cand[inds] * valid[:, None]
    gt_idx = (assign.assigned_gt_inds[inds] - 1).clamp(0, gt_bboxes.shape[0] - 1)
    zero = torch.zeros_like(gt_idx)
    labels = torch.where(pos, gt_labels[gt_idx].long(), zero)
    posf = pos.float()
    deltas = bbox2delta(rois, gt_bboxes[gt_idx], target_means, target_stds)
    if gt_pids is not None:
        ids = torch.where(pos, gt_pids[gt_idx].long(), zero)
        id_weights = posf
    else:
        ids, id_weights = zero, torch.zeros_like(posf)
    if gt_masks is not None:
        # targets for the positive prefix only (positives-first slots)
        n_pos_max = int(num * s["pos_fraction"])
        mask_targets = crop_and_resize_indexed(
            gt_masks, gt_idx[:n_pos_max], rois[:n_pos_max],
            cfg.get("mask_size", 28)) * posf[:n_pos_max, None, None]
    else:
        mask_targets = rois.new_zeros((0, 0, 0))
    return SampledRois(
        rois, labels, valid.float(), deltas * posf[:, None],
        posf[:, None].expand(-1, 4), ids, id_weights, pos, valid, gt_idx,
        mask_targets, sample.num_pos, sample.num_neg,
        (inds >= proposals.shape[0]) & valid)
