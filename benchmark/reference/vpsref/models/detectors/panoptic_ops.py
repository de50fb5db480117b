"""Panoptic fusion primitives (port of
vps_tpu/models/detectors/panoptic_ops.py): UPSNet box decode, MaskROI
detection selection, the windowed mask paste, MaskRemoval + SegTerm/MaskTerm
+ streaming panoptic argmax, and greedy track association over a
fixed-capacity track memory. Fixed capacities and validity masks as in JAX,
so every output compares element by element.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from reference.vpsref.ops.nms import NEG_INF, nms, top_k


PRE_NMS = 256
FRACTION_THRESHOLD = 0.3  # MaskRemoval: drop a mask covered more than this


def delta2bbox_upsnet(rois, deltas, reg_weights=(10.0, 10.0, 5.0, 5.0),
                      max_shape=None):
    """rois (N, 4), deltas (N, 4K) -> (N, K, 4); x2 = cx + w/2 - 1, clipped
    to [0, size - 1]."""
    n = rois.shape[0]
    k = deltas.shape[-1] // 4
    widths = rois[:, 2] - rois[:, 0] + 1.0
    heights = rois[:, 3] - rois[:, 1] + 1.0
    ctr_x = rois[:, 0] + 0.5 * widths
    ctr_y = rois[:, 1] + 0.5 * heights
    d = deltas.reshape(n, k, 4)
    wx, wy, ww, wh = reg_weights
    clip = math.log(1000.0 / 16.0)
    dx = d[..., 0] / wx
    dy = d[..., 1] / wy
    dw = (d[..., 2] / ww).clamp(max=clip)
    dh = (d[..., 3] / wh).clamp(max=clip)
    px = dx * widths[:, None] + ctr_x[:, None]
    py = dy * heights[:, None] + ctr_y[:, None]
    pw = torch.exp(dw) * widths[:, None]
    ph = torch.exp(dh) * heights[:, None]
    out = torch.stack([px - 0.5 * pw, py - 0.5 * ph,
                       px + 0.5 * pw - 1.0, py + 0.5 * ph - 1.0], dim=-1)
    if max_shape is not None:
        h, w = max_shape
        lim = torch.tensor([w - 1.0, h - 1.0, w - 1.0, h - 1.0],
                           device=out.device)
        out = torch.minimum(out.clamp(min=0.0), lim)
    return out


def panoptic_dets(rois, roi_valid, cls_prob, bbox_pred, img_shape,
                  score_thresh=0.6, nms_thresh=0.5, top_n=100,
                  reg_weights=(10.0, 10.0, 5.0, 5.0)):
    """MaskROI, class-agnostic: every (proposal, fg class) pair above
    score_thresh enters one pooled NMS (the best PRE_NMS of them: at
    score_thresh 0.6 the pool is far smaller in practice); survivors are
    capped at top_n. Returns (boxes (top_n, 4), probs, 1-based classes,
    valid)."""
    boxes_all = delta2bbox_upsnet(rois, bbox_pred, reg_weights, img_shape)
    return panoptic_dets_from_decoded(boxes_all, cls_prob, roi_valid,
                                      score_thresh, nms_thresh, top_n)


def panoptic_dets_from_decoded(boxes_all, cls_prob, roi_valid,
                               score_thresh=0.6, nms_thresh=0.5, top_n=100):
    """MaskROI after the decode: per-class boxes (N, C, 4) and class probs
    (N, C) in; ``predict_aug`` feeds the variants' averaged boxes and
    probs here (mmdet's merge_aug_bboxes, then one NMS)."""
    n, num_classes = cls_prob.shape
    boxes_fg = boxes_all[:, 1:, :].reshape(-1, 4)
    probs_fg = cls_prob[:, 1:].reshape(-1)
    cls_fg = torch.arange(1, num_classes, device=cls_prob.device).repeat(n)
    cand_valid = (probs_fg > score_thresh) & roi_valid.repeat_interleave(
        num_classes - 1)
    pre_nms = min(PRE_NMS, boxes_fg.shape[0])
    masked = torch.where(cand_valid, probs_fg, torch.full_like(probs_fg, NEG_INF))
    top_scores, top_idx = top_k(masked, pre_nms)
    top_boxes = boxes_fg[top_idx]
    top_valid = top_scores > NEG_INF / 2
    keep = nms(top_boxes, top_scores.clamp(min=0.0), nms_thresh, valid=top_valid)
    kept = torch.where(keep, top_scores, torch.full_like(top_scores, NEG_INF))
    det_scores, det_idx = top_k(kept, top_n)
    det_valid = det_scores > NEG_INF / 2
    det_boxes = top_boxes[det_idx] * det_valid[:, None]
    det_cls = torch.where(det_valid, cls_fg[top_idx][det_idx],
                          torch.zeros_like(det_idx))
    det_probs = torch.where(det_valid, det_scores, torch.zeros_like(det_scores))
    return det_boxes, det_probs, det_cls, det_valid


def _paste_logit_window(masks, boxes, out_hw):
    """MaskTerm/MaskRemoval paste for a batch of V dets: trunc-int box,
    bilinear (half-pixel) resize of each 28x28 logit map to its trunc size,
    placed in [y0, y2 + 1) x [x0, x2 + 1). masks (V, m, m), boxes (V, 4).
    Returns ((V, H, W) values, (V, H, W) window)."""
    hh, ww = out_hw
    v, m = masks.shape[:2]
    dev = masks.device
    x0 = torch.floor(boxes[:, 0])
    y0 = torch.floor(boxes[:, 1])
    w_ext = torch.floor(boxes[:, 2]) - x0 + 1.0
    h_ext = torch.floor(boxes[:, 3]) - y0 + 1.0
    w = w_ext.clamp(min=1.0)
    h = h_ext.clamp(min=1.0)
    py = torch.arange(hh, dtype=torch.float32, device=dev)[None] - y0[:, None]
    px = torch.arange(ww, dtype=torch.float32, device=dev)[None] - x0[:, None]
    window = (((py >= 0) & (py < h_ext[:, None]))[:, :, None]
              & ((px >= 0) & (px < w_ext[:, None]))[:, None, :])
    sy = ((py + 0.5) * (m / h)[:, None] - 0.5).clamp(0.0, m - 1.0)
    sx = ((px + 0.5) * (m / w)[:, None] - 0.5).clamp(0.0, m - 1.0)
    y0i = torch.floor(sy).long()
    x0i = torch.floor(sx).long()
    y1i = (y0i + 1).clamp(max=m - 1)
    x1i = (x0i + 1).clamp(max=m - 1)
    wy = (sy - y0i)[:, :, None]
    wx = (sx - x0i)[:, None, :]

    def tap(yi, xi):  # rows yi of each mask, then columns xi
        rows = masks.gather(1, yi[:, :, None].expand(v, hh, m))
        return rows.gather(2, xi[:, None, :].expand(v, hh, ww))

    # the four corner terms summed in the JAX order, one (V, H, W) tap alive
    # at a time
    vals = tap(y0i, x0i) * (1 - wy) * (1 - wx)
    vals = vals + tap(y0i, x1i) * (1 - wy) * wx
    vals = vals + tap(y1i, x0i) * wy * (1 - wx)
    vals = vals + tap(y1i, x1i) * wy * wx
    return torch.where(window, vals, torch.zeros_like(vals)), window


def _seg_window(boxes, out_hw):
    """SegTerm windows of a batch of boxes (V, 4) -> (V, H, W):
    [trunc(y1), round(y2) + 1) x [trunc(x1), round(x2) + 1)."""
    hh, ww = out_hw
    ys = torch.arange(hh, dtype=torch.float32, device=boxes.device)[None]
    xs = torch.arange(ww, dtype=torch.float32, device=boxes.device)[None]
    rows = ((ys >= torch.floor(boxes[:, 1:2]))
            & (ys < torch.round(boxes[:, 3:4]) + 1.0))
    cols = ((xs >= torch.floor(boxes[:, 0:1]))
            & (xs < torch.round(boxes[:, 2:3]) + 1.0))
    return rows[:, :, None] & cols[:, None, :]


class PanopticFusion(NamedTuple):
    panoptic: torch.Tensor  # (H, W) 0..num_stuff-1 stuff, num_stuff + k instance k
    sseg: torch.Tensor  # (H, W) semantic argmax
    keep_cls: torch.Tensor  # (N,) 1-based class of kept dets, keep order
    keep_probs: torch.Tensor
    keep_obj_ids: torch.Tensor
    keep_valid: torch.Tensor
    num_keep: torch.Tensor  # 0-dim


def mask_removal_and_fuse(det_boxes, det_probs, det_cls, det_valid,
                          det_obj_ids, mask_logits28, fcn_output,
                          num_stuff: int = 11):
    """Full-res panoptic fusion for one frame. fcn_output is (K, H, W)
    (channel-first here). Dets are visited by descending prob; a det whose
    binarised pasted mask is covered > 30% by earlier kept masks of its class
    is dropped; each kept det becomes channel num_stuff + rank with logits
    SegTerm + pasted mask; the map is the running first-max-wins argmax.
    Every valid det's pasted mask and instance logits are computed in one
    batch; only the coverage and argmax updates run det by det, on the
    device (the order and classes come to the host once)."""
    n = det_boxes.shape[0]
    k, hh, ww = fcn_output.shape
    dev = fcn_output.device
    num_things = k - num_stuff
    if num_things > 31:
        raise ValueError(f"num_things={num_things} > 31 unsupported")
    order = torch.argsort(-torch.where(det_valid, det_probs,
                                       torch.full_like(det_probs, -math.inf)),
                          stable=True)
    best_val, best_idx = fcn_output[:num_stuff].max(0)
    best_idx = best_idx.int()
    sseg = fcn_output.argmax(0).int()
    coverage = torch.zeros((hh, ww), dtype=torch.int32, device=dev)
    rank = torch.zeros((), dtype=torch.long, device=dev)
    # valid dets sort first (invalid ones carry -inf)
    visit = order[:int(det_valid.sum())].tolist()
    all_cls = det_cls.tolist()
    classes = [int(all_cls[d]) for d in visit]
    keeps = []
    if visit:
        idx = torch.tensor(visit, device=dev)
        boxes = det_boxes[idx]
        vals, window = _paste_logit_window(mask_logits28[idx], boxes, (hh, ww))
        masks = (vals > 0.0) & window
        mask_sums = masks.sum((1, 2))
        mapped = torch.tensor([min(max(num_stuff - 1 + c, 0), k - 1)
                               for c in classes], device=dev)
        seg = fcn_output[mapped]
        inst = (torch.where(_seg_window(boxes, (hh, ww)), seg, torch.zeros_like(seg))
                + torch.where(window, vals, torch.zeros_like(vals)))
        del vals, window, seg
    for i, cls in enumerate(classes):
        bit = min(max(cls - 1, 0), num_things - 1)
        mask = masks[i]
        overlap = ((((coverage >> bit) & 1) == 1) & mask).sum()
        keep = (mask_sums[i] > 0) & (overlap / mask_sums[i].clamp(min=1)
                                     <= FRACTION_THRESHOLD)
        coverage = torch.where(keep & mask, coverage | (1 << bit), coverage)
        better = keep & (inst[i] > best_val)
        best_val = torch.where(better, inst[i], best_val)
        best_idx = torch.where(better, (num_stuff + rank).int(), best_idx)
        rank = rank + keep.long()
        keeps.append(keep)

    # kept dets' attributes at their rank; the others go to a dump slot n
    outs = [torch.zeros(n + 1, dtype=dt, device=dev)
            for dt in (torch.int32, torch.float32, torch.int32)]
    if keeps:
        kept = torch.stack(keeps)
        slot = torch.where(kept, kept.long().cumsum(0) - 1, n)
        for out, src in zip(outs, (det_cls, det_probs, det_obj_ids)):
            out.scatter_(0, slot, src[idx].to(out.dtype))
    keep_cls, keep_probs, keep_obj = (o[:n] for o in outs)
    keep_valid = torch.arange(n, device=dev) < rank
    return PanopticFusion(best_idx, sseg, keep_cls, keep_probs, keep_obj,
                          keep_valid, rank)


class TrackState(NamedTuple):
    feats: torch.Tensor  # (CAP, 7, 7, C) ROI features of tracked objects
    bboxes: torch.Tensor  # (CAP, 4)
    labels: torch.Tensor  # (CAP,)
    valid: torch.Tensor  # (CAP,) bool
    count: torch.Tensor  # 0-dim int


def empty_track_state(cap: int = 256, feat_hw: int = 7, feat_c: int = 256,
                      device="cuda") -> TrackState:
    return TrackState(
        torch.zeros((cap, feat_hw, feat_hw, feat_c), device=device),
        torch.zeros((cap, 4), device=device),
        torch.zeros((cap,), dtype=torch.int32, device=device),
        torch.zeros((cap,), dtype=torch.bool, device=device),
        torch.zeros((), dtype=torch.int32, device=device),
    )


def track_assign(comp_scores, det_boxes, det_labels, det_feats, det_valid,
                 state: TrackState):
    """Greedy det <-> memory association (panoptic_fusetrack.py:400-469).

    comp_scores (N, CAP+1), column 0 = new object, invalid memory columns
    -inf. Per-det argmax; a memory slot keeps its higher-scoring claimant and
    the loser becomes a new object in a second pass. The sequential decisions
    run on the host over the small score matrix; the memory payloads are
    then written on the device in one batched scatter each (the last det
    wins a slot shared at capacity saturation, as in JAX).
    Returns (det_obj_ids (N,), new state)."""
    comp = comp_scores.detach().float().cpu().numpy()
    dvalid = det_valid.cpu().numpy()
    n = comp.shape[0]
    cap = state.feats.shape[0]
    match_like = comp.max(1)
    match_ids = comp.argmax(1)
    valid = state.valid.cpu().numpy().copy()
    count = int(state.count)
    obj_ids = np.full(n, -1, np.int64)
    was_new = np.zeros(n, bool)
    best_scores = np.full(cap, -100.0, np.float32)
    best_ids = np.full(cap, -1, np.int64)

    def insert_new(i):
        nonlocal count
        slot = min(count, cap - 1)
        valid[slot] = True
        count = min(count + 1, cap)
        obj_ids[i] = slot
        was_new[i] = True

    for i in range(n):
        if not dvalid[i]:
            continue
        mid = int(match_ids[i])
        if mid == 0:
            insert_new(i)
            continue
        obj = min(max(mid - 1, 0), cap - 1)
        if match_like[i] > best_scores[obj]:
            prev = best_ids[obj]
            if prev >= 0:
                obj_ids[min(prev, n - 1)] = -1
            obj_ids[i] = obj
            best_scores[obj] = match_like[i]
            best_ids[obj] = i
    for i in range(n):
        if dvalid[i] and obj_ids[i] < 0:
            insert_new(i)

    write = dvalid & (obj_ids >= 0)
    winner = np.full(cap + 1, -1, np.int64)
    np.maximum.at(winner, np.where(write, obj_ids, cap), np.arange(n))
    write &= winner[np.where(write, obj_ids, cap)] == np.arange(n)
    dev = state.feats.device
    rows = torch.from_numpy(np.nonzero(write)[0]).to(dev)
    slots = torch.from_numpy(obj_ids[write]).to(dev)
    feats = state.feats.clone()
    feats[slots] = det_feats[rows].to(feats.dtype)
    bboxes = state.bboxes.clone()
    bboxes[slots] = det_boxes[rows].to(bboxes.dtype)
    new_rows = torch.from_numpy(np.nonzero(write & was_new)[0]).to(dev)
    labels = state.labels.clone()
    labels[torch.from_numpy(obj_ids[write & was_new]).to(dev)] = \
        det_labels[new_rows].to(labels.dtype)
    new_state = TrackState(
        feats, bboxes, labels, torch.from_numpy(valid).to(dev),
        torch.tensor(count, dtype=torch.int32, device=dev))
    obj = torch.from_numpy(np.where(dvalid, obj_ids, -1)).to(dev)
    return obj, new_state
