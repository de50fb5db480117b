"""Detection mAP and proposal recall (the port's copy of the JAX package's
``eval/mean_ap.py``, mmdet's ``core/evaluation`` mean_ap and recall):
VOC-style AP with 'area' or '11points' interpolation, per-class tp/fp
marking at an IoU threshold with difficult/ignore handling, and proposal
recall curves. Host numpy, as in the JAX package, and its IoU matrix from
the native host library (``vps_torch.native.bbox_overlaps``), as the JAX
package's: the same float32 casts, stable sorts and float32 eps, so the
numbers are the same bit for bit.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from vps_torch.native import bbox_overlaps


def average_precision(recalls: np.ndarray, precisions: np.ndarray,
                      mode: str = "area") -> np.ndarray:
    """AP from (scales, N) or (N,) recall/precision curves: the area under
    the monotone precision envelope ('area') or the mean of the best
    precision at the 11 recalls 0, 0.1, ..., 1 ('11points')."""
    no_scale = recalls.ndim == 1
    if no_scale:
        recalls = recalls[None]
        precisions = precisions[None]
    num_scales = recalls.shape[0]
    ap = np.zeros(num_scales, np.float32)
    if mode == "area":
        zeros = np.zeros((num_scales, 1), recalls.dtype)
        ones = np.ones((num_scales, 1), recalls.dtype)
        mrec = np.hstack((zeros, recalls, ones))
        mpre = np.hstack((zeros, precisions, zeros))
        for i in range(mpre.shape[1] - 1, 0, -1):
            mpre[:, i - 1] = np.maximum(mpre[:, i - 1], mpre[:, i])
        for i in range(num_scales):
            ind = np.where(mrec[i, 1:] != mrec[i, :-1])[0]
            ap[i] = np.sum((mrec[i, ind + 1] - mrec[i, ind]) * mpre[i, ind + 1])
    elif mode == "11points":
        for i in range(num_scales):
            for thr in np.arange(0, 1 + 1e-3, 0.1):
                precs = precisions[i, recalls[i, :] >= thr]
                ap[i] += precs.max() if precs.size > 0 else 0
        ap /= 11
    else:
        raise ValueError(mode)
    return ap[0] if no_scale else ap


def tpfp_default(
    det_bboxes: np.ndarray,
    gt_bboxes: np.ndarray,
    gt_ignore: Optional[np.ndarray] = None,
    iou_thr: float = 0.5,
) -> Tuple[np.ndarray, np.ndarray]:
    """Mark each detection (n, 5) tp or fp: greedy by descending score
    (stable), each det against its best-IoU gt; a det whose best gt is
    ignored is neither tp nor fp, a second det on a covered gt is fp."""
    num_dets = det_bboxes.shape[0]
    num_gts = gt_bboxes.shape[0]
    if gt_ignore is None:
        gt_ignore = np.zeros(num_gts, bool)
    tp = np.zeros(num_dets, np.float32)
    fp = np.zeros(num_dets, np.float32)
    if num_gts == 0:
        fp[:] = 1
        return tp, fp
    if num_dets == 0:
        return tp, fp
    ious = bbox_overlaps(det_bboxes[:, :4], gt_bboxes)
    ious_max = ious.max(axis=1)
    ious_argmax = ious.argmax(axis=1)
    sort_inds = np.argsort(-det_bboxes[:, -1], kind="stable")
    gt_covered = np.zeros(num_gts, bool)
    for i in sort_inds:
        if ious_max[i] >= iou_thr:
            matched = ious_argmax[i]
            if gt_ignore[matched]:
                continue
            if not gt_covered[matched]:
                gt_covered[matched] = True
                tp[i] = 1
            else:
                fp[i] = 1
        else:
            fp[i] = 1
    return tp, fp


def eval_map(
    det_results: List[List[np.ndarray]],
    gt_bboxes: List[np.ndarray],
    gt_labels: List[np.ndarray],
    gt_ignore: Optional[List[np.ndarray]] = None,
    iou_thr: float = 0.5,
    mode: str = "area",
    dataset: Optional[Sequence[str]] = None,
    print_summary: bool = True,
) -> Tuple[float, List[Dict]]:
    """Mean AP over the classes that have a gt.

    det_results: per image, a list of per-class (n, 5) arrays (x1, y1, x2,
    y2, score); gt_bboxes, gt_labels: per image; labels are 1-based (class
    c of det_results is label c + 1). Returns (mAP, per-class results)."""
    num_classes = len(det_results[0])
    num_imgs = len(det_results)
    eval_results = []
    for c in range(num_classes):
        cls_dets, cls_gts, cls_ignore = [], [], []
        for i in range(num_imgs):
            cls_dets.append(det_results[i][c])
            mask = gt_labels[i] == c + 1
            cls_gts.append(gt_bboxes[i][mask])
            if gt_ignore is not None:
                cls_ignore.append(gt_ignore[i][mask].astype(bool))
            else:
                cls_ignore.append(np.zeros(int(mask.sum()), bool))
        tp_list, fp_list = [], []
        for dets, gts, ign in zip(cls_dets, cls_gts, cls_ignore):
            t, f = tpfp_default(dets, gts, ign, iou_thr)
            tp_list.append(t)
            fp_list.append(f)
        num_gts = sum(int((~ign).sum()) for ign in cls_ignore)
        all_dets = np.vstack(cls_dets) if cls_dets else np.zeros((0, 5))
        all_tp = np.concatenate(tp_list) if tp_list else np.zeros(0)
        all_fp = np.concatenate(fp_list) if fp_list else np.zeros(0)
        rank = np.argsort(-all_dets[:, -1], kind="stable")
        all_tp = np.cumsum(all_tp[rank])
        all_fp = np.cumsum(all_fp[rank])
        eps = np.finfo(np.float32).eps
        recalls = all_tp / max(num_gts, eps)
        precisions = all_tp / np.maximum(all_tp + all_fp, eps)
        ap = average_precision(recalls, precisions, mode) if num_gts > 0 else 0.0
        eval_results.append(dict(
            num_gts=num_gts,
            num_dets=int(all_dets.shape[0]),
            recall=float(recalls[-1]) if recalls.size else 0.0,
            precision=float(precisions[-1]) if precisions.size else 0.0,
            ap=float(ap),
        ))
    aps = [r["ap"] for r in eval_results if r["num_gts"] > 0]
    mean_ap = float(np.mean(aps)) if aps else 0.0
    if print_summary:
        print_map_summary(mean_ap, eval_results, dataset)
    return mean_ap, eval_results


def print_map_summary(mean_ap, results, dataset=None):
    """One line a class (gts, dets, recall, AP), then the mAP."""
    print(f"{'class':<16}{'gts':>8}{'dets':>8}{'recall':>8}{'ap':>8}")
    for i, r in enumerate(results):
        name = dataset[i] if dataset else str(i + 1)
        print(f"{name:<16}{r['num_gts']:>8}{r['num_dets']:>8}"
              f"{r['recall']:>8.3f}{r['ap']:>8.3f}")
    print(f"{'mAP':<16}{'':>8}{'':>8}{'':>8}{mean_ap:>8.3f}")


def _recalls(all_ious: List[np.ndarray], proposal_nums, thrs) -> np.ndarray:
    """(len(proposal_nums), len(thrs)) recalls: for each image, each gt
    takes the best free proposal among the first ``num`` (greedy over the
    largest IoU left)."""
    img_num = len(all_ious)
    recalls = np.zeros((len(proposal_nums), len(thrs)))
    for k, num in enumerate(proposal_nums):
        tmp_ious = np.zeros(0)
        gt_count = 0
        for i in range(img_num):
            ious = all_ious[i][:, :num] if all_ious[i].size else all_ious[i]
            gt_count += all_ious[i].shape[0]
            if ious.size == 0:
                continue
            ious = ious.copy()
            gt_best = np.zeros(ious.shape[0])
            for _ in range(ious.shape[0]):
                gi, pi = np.unravel_index(np.argmax(ious), ious.shape)
                if ious[gi, pi] <= 0:
                    break
                gt_best[gi] = ious[gi, pi]
                ious[gi, :] = -1
                ious[:, pi] = -1
            tmp_ious = np.concatenate([tmp_ious, gt_best])
        for j, thr in enumerate(thrs):
            recalls[k, j] = (tmp_ious >= thr).sum() / max(gt_count, 1)
    return recalls


def eval_recalls(
    gts: List[np.ndarray],
    proposals: List[np.ndarray],
    proposal_nums=(100, 300, 1000),
    iou_thrs=(0.5,),
) -> np.ndarray:
    """Proposal recall, (len(proposal_nums), len(iou_thrs)); proposals with
    a score column are ranked by it (stable) first."""
    all_ious = []
    for g, p in zip(gts, proposals):
        if p.shape[1] == 5:
            p = p[np.argsort(-p[:, 4], kind="stable")][:, :4]
        if g.size == 0 or p.size == 0:
            all_ious.append(np.zeros((g.shape[0], p.shape[0])))
            continue
        all_ious.append(bbox_overlaps(g, p))
    return _recalls(all_ious, list(proposal_nums), list(iou_thrs))
