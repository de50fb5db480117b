"""The numbers that decide ``correct``: the program's outputs against the
reference's, on the same inputs.

Every number is a share or a gap that a rounding flip (a det at a score or
NMS tie, a pixel at an argmax tie) moves a little and a wrong or
lower-precision path moves far more. Each is held to the limit its cell's
workload file gives.
"""

from __future__ import annotations

import math

import numpy as np

MATCH_IOU = 0.5  # an instance's mask matches at this IoU and one class
BOX_IOU = 0.9  # a detection's box matches at this IoU and one label
# leaves whose reference gradient is under this share of the median leaf's
# move by round-off alone (a key's bias under softmax), and are not judged
NEGLIGIBLE_GRAD = 1e-3


def _instances(out, num_stuff):
    """(instance index map, -1 where none; instance classes; their ids) of
    the kept instances that hold a pixel of the map, renumbered."""
    pan = out["panoptic_outputs"].astype(np.int64)
    n = int(np.asarray(out["num_keep"]).reshape(-1)[0])
    inst = pan - num_stuff
    inst = np.where((inst >= 0) & (inst < n), inst, -1)
    present = np.unique(inst[inst >= 0])
    renum = np.full(n + 1, -1, np.int64)
    renum[present] = np.arange(len(present))
    cls = np.asarray(out["panoptic_cls_inds"])[present]
    ids = np.asarray(out["panoptic_det_obj_ids"])[present]
    return renum[inst], cls, ids


def _match_instances(a, b):
    """Pairs (i, j) of instances of ``a`` and ``b`` (each _instances'
    result) of one class at mask IoU >= MATCH_IOU, and each side's
    instance areas in pixels."""
    (ma, ca, _), (mb, cb, _) = a, b
    na, nb = len(ca), len(cb)
    joint = np.bincount(((ma + 1) * (nb + 1) + (mb + 1)).ravel(),
                        minlength=(na + 1) * (nb + 1)).reshape(na + 1, nb + 1)
    area_a, area_b = joint[1:].sum(1), joint[:, 1:].sum(0)
    pairs = []
    if na and nb:
        inter = joint[1:, 1:].astype(np.float64)
        iou = inter / np.maximum(area_a[:, None] + area_b[None] - inter, 1)
        for i in range(na):
            j = int(np.argmax(iou[i]))
            if iou[i, j] >= MATCH_IOU and ca[i] == cb[j]:
                pairs.append((i, j))
    return pairs, area_a, area_b


def _pairs(ba, la, bb, lb, thr):
    """One-to-one pairs (i, j) of boxes of one label at box IoU >= thr,
    the largest IoU first."""
    if len(ba) == 0 or len(bb) == 0:
        return []
    iou = _box_iou(ba, bb) * (la[:, None] == lb[None])
    pairs = []
    while True:
        i, j = np.unravel_index(int(np.argmax(iou)), iou.shape)
        if iou[i, j] < thr:
            return pairs
        pairs.append((int(i), int(j)))
        iou[i, :] = -1.0
        iou[:, j] = -1.0


def _dets(o):
    v = np.asarray(o["det_valid"]).astype(bool)
    return np.asarray(o["det_bboxes"])[v][:, :4], np.asarray(o["det_labels"])[v]


def video(prog, ref, rep, num_stuff):
    """Numbers of one video: ``prog``, ``ref`` and ``rep`` are the frames'
    outputs (numpy dicts) in order, the first after a reset: the program's,
    the reference's own, and the reference's track head, memory, mask head
    and fusion run on the program's detections (``drive._Replay``).

    sem_disagree: the worst frame's share of pixels whose semantic class
    differs from the reference's. det_unmatched: the worst frame's share of
    detections, on the side with more, left without a detection of the
    other side of one label at box IoU 0.9, paired one to one (the RPN, its
    NMS, the box head and the panoptic NMS). fusion_unmatched: over the
    video, the pixels of the kept instances of the program and of the
    replay that have no instance of the other of one class at mask IoU
    0.5, over all their instance pixels (the mask head and the fusion).
    track_disagree: over consecutive frames, of the pairs of matched
    instances that the program or the replay tracks as one object, the
    share where the other does not (the track head and its memory)."""
    sem, det = 0.0, 0.0
    unmatched, total = 0, 0
    same_pairs, disagree = 0, 0
    prev = None
    for p, r, q in zip(prog, ref, rep):
        sem = max(sem, float(np.mean(p["fcn_outputs"] != r["fcn_outputs"])))
        (bp, lp), (br, lr) = _dets(p), _dets(r)
        n = max(len(bp), len(br))
        if n:
            det = max(det, 1.0 - len(_pairs(bp, lp, br, lr, BOX_IOU)) / n)
        ip, iq = _instances(p, num_stuff), _instances(q, num_stuff)
        pairs, area_p, area_q = _match_instances(ip, iq)
        both = int(area_p.sum() + area_q.sum())
        total += both
        unmatched += both - int(sum(area_p[i] + area_q[j] for i, j in pairs))
        if prev is not None:
            pp, pip, piq = prev
            for a, a2 in pp:
                for b, b2 in pairs:
                    ps = pip[2][a] == ip[2][b]
                    qs = piq[2][a2] == iq[2][b2]
                    if ps or qs:
                        same_pairs += 1
                        disagree += int(ps != qs)
        prev = (pairs, ip, iq)
    return {"sem_disagree": sem, "det_unmatched": det,
            "fusion_unmatched": unmatched / max(total, 1),
            "track_disagree": disagree / max(same_pairs, 1)}


def _box_iou(a, b):
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:4], b[None, :, 2:4])
    wh = np.clip(rb - lt + 1, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    area = lambda x: (x[:, 2] - x[:, 0] + 1) * (x[:, 3] - x[:, 1] + 1)
    return inter / np.maximum(area(a)[:, None] + area(b)[None] - inter, 1e-9)


def images(prog, ref):
    """Numbers of the sampled images, each (boxes with scores (n, 5),
    labels, masks (n, H, W) bool) on both sides.

    det_unmatched: the worst image's share of detections, on the side with
    more, with no detection of the other side of one label at box IoU 0.9,
    paired one to one. box_gap: the largest difference of a box coordinate
    of a pair, in pixels. score_gap: the largest score difference of a
    pair. mask_disagree: of the pairs' pasted masks, the pixels set on one
    side only over the pixels set on either."""
    unmatched, box, score, xor, union = 0.0, 0.0, 0.0, 0, 0
    for (bp, lp, mp), (br, lr, mr) in zip(prog, ref):
        n = max(len(bp), len(br))
        if n == 0:
            continue
        pairs = _pairs(bp, lp, br, lr, BOX_IOU)
        unmatched = max(unmatched, 1.0 - len(pairs) / n)
        for i, j in pairs:
            box = max(box, float(np.abs(bp[i, :4].astype(np.float64)
                                        - br[j, :4]).max()))
            score = max(score, abs(float(bp[i, 4]) - float(br[j, 4])))
            xor += int(np.count_nonzero(mp[i] ^ mr[j]))
            union += int(np.count_nonzero(mp[i] | mr[j]))
    return {"det_unmatched": unmatched, "box_gap": box, "score_gap": score,
            "mask_disagree": xor / max(union, 1)}


def _leaf_gaps(prog, ref, kept):
    """{leaf: gap of the two sides' norms over the reference's norm of the
    leaf or of the median leaf, whichever is larger}."""
    med = float(np.median([ref[n] for n in kept])) if kept else 0.0
    gaps = {}
    for n in kept:
        gap = abs(prog[n] - ref[n]) / max(ref[n], med, 1e-30)
        gaps[n] = gap if math.isfinite(gap) else math.inf
    return gaps


def train(prog, ref):
    """Numbers of the first three steps.

    loss_gap: the largest relative gap of a step's total loss. grad_gap:
    the worst leaf's gap between the two sides' norms of the first step's
    gradient as the optimizer got it (clipped), over the reference's norm
    of that leaf or of the median leaf, whichever is larger. change_gap: the
    same of the norm of each leaf's change after three steps. Leaves whose
    reference gradient is under NEGLIGIBLE_GRAD of the median leaf's are
    left out of both. The ``*_median`` numbers are the median leaf's gap,
    and ``term_gap.<loss>`` each first-step loss term's relative gap."""
    loss = max(abs(a - b) / max(abs(b), 1e-30)
               for a, b in zip(prog["loss"], ref["loss"]))
    if not all(math.isfinite(v) for v in prog["loss"]):
        loss = math.inf
    med = float(np.median(list(ref["grad"].values())))
    kept = [n for n, v in ref["grad"].items() if v >= NEGLIGIBLE_GRAD * med]
    grad = _leaf_gaps(prog["grad"], ref["grad"], kept)
    change = _leaf_gaps(prog["change"], ref["change"], kept)
    out = {"loss_gap": loss,
           "grad_gap": max(grad.values()),
           "change_gap": max(change.values()),
           "change_gap_median": float(np.median(list(change.values())))}
    terms = {k: abs(prog["terms"][0][k] - v) / max(abs(v), 1e-30)
             for k, v in ref["terms"][0].items() if k != "loss"}
    out["term_gap"] = float(np.median(list(terms.values())))
    for k, v in terms.items():
        out[f"term_gap.{k}"] = v
    return out
