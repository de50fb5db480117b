"""VPQ: Video Panoptic Quality by tube matching (the port's copy of the JAX
package's ``eval/vpq.py``).

The reference's math: for every temporal window of `nframes` consecutive
annotated frames, segments with the same id across frames form tubes; tube
IoU > 0.5 under matching category is a TP; crowd GT ignored; predictions
mostly covered by VOID+crowd are ignored. VPQ is PQ over tubes, averaged
over window sizes k in {0, 5, 10, 15} (nframes in {1..4}).
"""

from __future__ import annotations

import copy
import os
from typing import Dict, List, Sequence, Tuple

import numpy as np

from vps_torch.eval.pq import PQStat

OFFSET = 256 * 256 * 256
VOID = 0


def _rgb_to_id(pan_rgb: np.ndarray) -> np.ndarray:
    p = pan_rgb.astype(np.uint32)
    return p[..., 0] + p[..., 1] * 256 + p[..., 2] * 256 * 256


def _collect_segms(json_ann: dict) -> Dict[int, dict]:
    out: Dict[int, dict] = {}
    for el in json_ann["segments_info"]:
        if el["id"] in out:
            out[el["id"]]["area"] += el["area"]
        else:
            out[el["id"]] = copy.deepcopy(el)
    return out


def vpq_compute_video(
    frames: Sequence[Tuple[dict, dict, np.ndarray, np.ndarray]],
    categories: Dict[int, dict],
    nframes: int,
    size_thr: int = 0,
) -> PQStat:
    """frames: per annotated frame (gt_json, pred_json, gt_pan_rgb,
    pred_pan_rgb). Slides a window of `nframes` over the video.

    ``size_thr``: VIPER's small-GT skip (GT tubes smaller than the
    threshold neither match nor count as FN); 0 = the Cityscapes-VPS
    protocol, which has no size filter."""
    stat = PQStat()
    for start in range(0, len(frames) - nframes + 1):
        window = frames[start : start + nframes]
        gt_ids = []
        pred_ids = []
        vid_gt_segms: Dict[int, dict] = {}
        vid_pred_segms: Dict[int, dict] = {}
        for gt_json, pred_json, gt_pan, pred_pan in window:
            gt_id_map = _rgb_to_id(gt_pan)
            pred_id_map = _rgb_to_id(pred_pan)
            gt_segms = _collect_segms(gt_json)
            pred_segms = _collect_segms(pred_json)
            # recompute pred areas from the png (sanity, as the reference)
            labels, cnts = np.unique(pred_id_map, return_counts=True)
            declared = set(pred_segms)
            for label, cnt in zip(labels.tolist(), cnts.tolist()):
                if label == VOID:
                    continue
                if label not in pred_segms:
                    raise KeyError(
                        f"segment id {label} in PNG but not in JSON"
                    )
                pred_segms[label]["area"] = cnt
                declared.discard(label)
            if declared:
                raise KeyError(f"segment ids {sorted(declared)} in JSON but not PNG")
            gt_ids.append(gt_id_map)
            pred_ids.append(pred_id_map)
            for k, v in gt_segms.items():
                if k in vid_gt_segms:
                    vid_gt_segms[k]["area"] += v["area"]
                else:
                    vid_gt_segms[k] = v
            for k, v in pred_segms.items():
                if k in vid_pred_segms:
                    vid_pred_segms[k]["area"] += v["area"]
                else:
                    vid_pred_segms[k] = v

        gt_tube = np.stack(gt_ids).astype(np.uint64)
        pred_tube = np.stack(pred_ids).astype(np.uint64)
        pairs, inters = np.unique(
            gt_tube * OFFSET + pred_tube, return_counts=True
        )
        gt_pred_map = {
            (int(p // OFFSET), int(p % OFFSET)): int(c)
            for p, c in zip(pairs.tolist(), inters.tolist())
        }

        gt_small = set()
        if size_thr > 0:
            labels, cnts = np.unique(gt_tube, return_counts=True)
            gt_small = {
                int(l) for l, c in zip(labels.tolist(), cnts.tolist())
                if c < size_thr
            }

        gt_matched = set()
        pred_matched = set()
        for (gt_label, pred_label), intersection in gt_pred_map.items():
            if gt_label in gt_small:
                continue
            if gt_label not in vid_gt_segms or pred_label not in vid_pred_segms:
                continue
            g = vid_gt_segms[gt_label]
            p = vid_pred_segms[pred_label]
            if g.get("iscrowd", 0) == 1:
                continue
            if g["category_id"] != p["category_id"]:
                continue
            union = (
                p["area"] + g["area"] - intersection
                - gt_pred_map.get((VOID, pred_label), 0)
            )
            iou = intersection / union
            if iou > 0.5:
                stat[g["category_id"]].tp += 1
                stat[g["category_id"]].iou += iou
                gt_matched.add(gt_label)
                pred_matched.add(pred_label)

        crowd_by_cat: Dict[int, int] = {}
        for gt_label, g in vid_gt_segms.items():
            if gt_label in gt_matched:
                continue
            if g.get("iscrowd", 0) == 1:
                crowd_by_cat[g["category_id"]] = gt_label
                continue
            if gt_label in gt_small:
                continue
            stat[g["category_id"]].fn += 1

        for pred_label, p in vid_pred_segms.items():
            if pred_label in pred_matched:
                continue
            inter = gt_pred_map.get((VOID, pred_label), 0)
            if p["category_id"] in crowd_by_cat:
                inter += gt_pred_map.get(
                    (crowd_by_cat[p["category_id"]], pred_label), 0
                )
            if inter / p["area"] > 0.5:
                continue
            stat[p["category_id"]].fp += 1
    return stat


def vpq_compute(
    videos: Sequence[Sequence[Tuple[dict, dict, np.ndarray, np.ndarray]]],
    categories: Dict[int, dict],
    nframes: int,
    output_dir: str = None,
):
    """Returns (vpq_all, vpq_thing, vpq_stuff) percentages for one window
    size; optionally writes vpq-{k}.txt like the reference."""
    stat = PQStat()
    for video in videos:
        stat += vpq_compute_video(video, categories, nframes)
    results = {}
    per_class = {}
    for name, isthing in (("All", None), ("Things", True), ("Stuff", False)):
        results[name], pc = stat.pq_average(categories, isthing)
        if name == "All":
            per_class = pc
    if output_dir:
        k = (nframes - 1) * 5
        path = os.path.join(output_dir, f"vpq-{k}.txt")
        with open(path, "w") as f:
            f.write("=" * 48 + "\n")
            f.write("{:10s}| {:>5s}  {:>5s}  {:>5s} {:>5s}\n".format(
                "", "PQ", "SQ", "RQ", "N"))
            f.write("-" * 38 + "\n")
            for name in ("All", "Things", "Stuff"):
                r = results[name]
                f.write("{:10s}| {:5.1f}  {:5.1f}  {:5.1f} {:5d}\n".format(
                    name, 100 * r["pq"], 100 * r["sq"], 100 * r["rq"], r["n"]))
            for idx, r in per_class.items():
                f.write(
                    "{:4d} | {:5.1f} {:5.1f} {:5.1f} {:6.1f} {:7d} {:7d} {:7d}\n"
                    .format(idx, 100 * r["pq"], 100 * r["sq"], 100 * r["rq"],
                            r["iou"], r["tp"], r["fp"], r["fn"]))
    return (
        100 * results["All"]["pq"],
        100 * results["Things"]["pq"],
        100 * results["Stuff"]["pq"],
    )


def vpq_eval_all(
    videos,
    categories: Dict[int, dict],
    output_dir: str = None,
    window_sizes: Sequence[int] = (1, 2, 3, 4),
):
    """Averages over the protocol's windows; writes vpq-final.txt."""
    alls, things, stuffs = [], [], []
    for nf in window_sizes:
        a, t, s = vpq_compute(videos, categories, nf, output_dir)
        alls.append(a)
        things.append(t)
        stuffs.append(s)
    final = (
        sum(alls) / len(alls),
        sum(things) / len(things),
        sum(stuffs) / len(stuffs),
    )
    if output_dir:
        with open(os.path.join(output_dir, "vpq-final.txt"), "w") as f:
            f.write("vpq_all:%.4f\n" % final[0])
            f.write("vpq_thing:%.4f\n" % final[1])
            f.write("vpq_stuff:%.4f\n" % final[2])
    return final
