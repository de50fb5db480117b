"""VIPER panoptic and video-panoptic evaluation (the port's copy of the JAX
package's ``eval/viper.py``): the reference's ``Viper.evaluate_panoptic``
over the shared VPQ core.

- 2ch (semantic, -, track id) maps -> colour PNGs + segments_info through
  the OFFSET=1000 converter (``encode_panoptic_video``, with per-video
  track-id colour persistence).
- windows of ``nframes`` CONSECUTIVE frames in {1, 5, 10, 15} (image PQ for
  1, VPQ for 5/10/15), unlike Cityscapes-VPS, whose annotated frames are
  every 5th and whose windows are nframes in {1..4}.
- the SIZE_THR = 32^2 small-GT skip.
- per-class result tables written as ``{save_name}_vpq_nf%02d.txt``.

VIPER categories: 23 semantic classes, 10 things (ids 13..22 in the
panoptic json), num_stuff = 13.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Sequence

import numpy as np

from vps_torch.eval.pq import PQStat
from vps_torch.eval.unified import encode_panoptic_video
from vps_torch.eval.vpq import vpq_compute_video

SIZE_THR = 32 * 32
VIPER_WINDOWS = (1, 5, 10, 15)
VIPER_NUM_SEG_CLASSES = 23
VIPER_NUM_THING_CLASSES = 10


def default_viper_categories() -> Dict[int, dict]:
    """23 semantic classes, 10 of them things: stuff ids 0..12, thing ids
    13..22."""
    num_stuff = VIPER_NUM_SEG_CLASSES - VIPER_NUM_THING_CLASSES
    cats = {}
    for i in range(VIPER_NUM_SEG_CLASSES):
        cats[i] = dict(
            id=i,
            isthing=1 if i >= num_stuff else 0,
            color=[(i * 37 + 29) % 256, (i * 91 + 7) % 256,
                   (i * 173 + 83) % 256],
        )
    return cats


def _write_table(path: str, nframes: int, results: dict, per_class: dict):
    with open(path, "w") as f:
        f.write("============== for %d-frames =============\n" % nframes)
        f.write("{:10s}| {:>5s}  {:>5s}  {:>5s} {:>5s}\n".format(
            "", "PQ", "SQ", "RQ", "N"))
        f.write("-" * (10 + 7 * 4) + "\n")
        for name in ("All", "Things", "Stuff"):
            r = results[name]
            f.write("{:10s}| {:5.1f}  {:5.1f}  {:5.1f} {:5d}\n".format(
                name, 100 * r["pq"], 100 * r["sq"], 100 * r["rq"], r["n"]))
        f.write("{:4s}| {:>5s} {:>5s} {:>5s} {:>6s} {:>7s} {:>7s} {:>7s}\n"
                .format("IDX", "PQ", "SQ", "RQ", "IoU", "TP", "FP", "FN"))
        for idx, r in per_class.items():
            f.write(
                "{:4d} | {:5.1f} {:5.1f} {:5.1f} {:6.1f} {:7d} {:7d} {:7d}\n"
                .format(idx, 100 * r["pq"], 100 * r["sq"], 100 * r["rq"],
                        r["iou"], r["tp"], r["fp"], r["fn"]))


def viper_vpq_compute(
    videos: Sequence[Sequence[tuple]],
    categories: Dict[int, dict],
    nframes: int,
    output_dir: str = None,
    save_name: str = "viper",
):
    """One window size over per-video frame tuples (gt_json, pred_json,
    gt_pan_rgb, pred_pan_rgb): consecutive-frame windows, the SIZE_THR
    skip. Returns (results by All / Things / Stuff, per-class results)."""
    stat = PQStat()
    for video in videos:
        stat += vpq_compute_video(video, categories, nframes,
                                  size_thr=SIZE_THR)
    results = {}
    per_class = {}
    for name, isthing in (("All", None), ("Things", True), ("Stuff", False)):
        results[name], pc = stat.pq_average(categories, isthing)
        if name == "All":
            per_class = pc
    if output_dir:
        os.makedirs(output_dir, exist_ok=True)
        _write_table(
            os.path.join(output_dir, f"{save_name}_vpq_nf{nframes:02d}.txt"),
            nframes, results, per_class,
        )
    return results, per_class


def evaluate_panoptic_from_files(
    pred_pans_2ch: Sequence[np.ndarray],
    output_dir: str,
    pan_gt_json_file: str,
    pan_gt_folder: str,
    n_video: int,
    save_name: str = None,
    windows: Sequence[int] = VIPER_WINDOWS,
):
    """The reference's ``Viper.evaluate_panoptic`` from files: load the GT
    panoptic json and colour PNGs (a folder whose path names "viper" holds
    each image's basename as .png), encode the predictions video by video
    (the frames split into ``n_video`` equal runs, so track colours persist
    within a video only), save the ``pan_2ch/`` and ``pan/`` image folders
    and ``gt.json`` / ``pred.json``, then score window 1 (image PQ) and the
    VPQ windows, writing ``{save_name}_vpq_nfNN.txt`` tables. Returns
    {nframes: results}."""
    import cv2

    with open(pan_gt_json_file) as f:
        gt_json = json.load(f)
    files = [item["file_name"] for item in gt_json["images"]]
    if "viper" in pan_gt_folder:
        files = [f.split("/")[-1].replace(".jpg", ".png") for f in files]
    gt_pans = []
    for fn in files:
        img = cv2.imread(os.path.join(pan_gt_folder, fn), cv2.IMREAD_COLOR)
        if img is None:
            raise FileNotFoundError(os.path.join(pan_gt_folder, fn))
        gt_pans.append(img[..., ::-1])  # BGR -> RGB

    categories = {c["id"]: c for c in gt_json["categories"]}

    # per-video runs of frames, per-video colour persistence
    pred_chunks = np.array_split(np.arange(len(pred_pans_2ch)), n_video)
    pred_pans, pred_anns = [], []
    for chunk in pred_chunks:
        pans, anns = encode_panoptic_video(
            [pred_pans_2ch[i] for i in chunk], categories)
        pred_pans.extend(pans)
        pred_anns.extend(anns)
    pred_json = {"annotations": pred_anns}

    # the raw 2ch maps and the encoded colour maps, as images
    os.makedirs(output_dir, exist_ok=True)
    for sub, images in (("pan_2ch", pred_pans_2ch), ("pan", pred_pans)):
        folder = os.path.join(output_dir, sub)
        os.makedirs(folder, exist_ok=True)
        for item, img in zip(gt_json["images"], images):
            name = (item["file_name"].replace("_leftImg8bit", "")
                    .replace("jpg", "png").replace("jpeg", "png"))
            cv2.imwrite(os.path.join(folder, os.path.basename(name)),
                        np.asarray(img, np.uint8)[..., ::-1])
    with open(os.path.join(output_dir, "gt.json"), "w") as f:
        json.dump(gt_json, f)
    with open(os.path.join(output_dir, "pred.json"), "w") as f:
        json.dump(pred_json, f)

    # GT and predictions paired video by video, in the same runs
    gt_anns = gt_json["annotations"]
    videos = []
    for chunk in pred_chunks:
        videos.append([
            (gt_anns[i], pred_anns[i], gt_pans[i], pred_pans[i])
            for i in chunk
        ])

    save_name = save_name or os.path.join(output_dir, "viper")
    all_results = {}
    for nf in windows:
        results, per_class = viper_vpq_compute(
            videos, categories, nf, output_dir=output_dir,
            save_name=os.path.basename(save_name),
        )
        all_results[nf] = dict(results, per_class=per_class)
    return all_results


def evaluate_panoptic_viper(
    pred_pans_2ch_videos: Sequence[Sequence[np.ndarray]],
    gt_videos: Sequence[Sequence[tuple]],
    categories: Dict[int, dict] = None,
    output_dir: str = None,
    save_name: str = "viper",
    windows: Sequence[int] = VIPER_WINDOWS,
):
    """The whole ``Viper.evaluate_panoptic`` in memory: encode each video's
    2ch predictions, pair them with its GT frame by frame, score every
    window, write the per-window tables. Returns {nframes: results}.

    pred_pans_2ch_videos: per video, per frame (H, W, 3) 2ch maps
    (ch0 = semantic class, ch2 = track id; 255 = void).
    gt_videos: per video, per frame (gt_json, gt_pan_rgb).
    """
    if categories is None:
        categories = default_viper_categories()
    videos: List[List[tuple]] = []
    for pred_2ch, gt_frames in zip(pred_pans_2ch_videos, gt_videos):
        pred_pans, pred_anns = encode_panoptic_video(pred_2ch, categories)
        assert len(pred_pans) == len(gt_frames)
        videos.append([
            (gt_json, pred_json, gt_pan, pred_pan)
            for (gt_json, gt_pan), pred_json, pred_pan
            in zip(gt_frames, pred_anns, pred_pans)
        ])
    all_results = {}
    for nf in windows:
        results, per_class = viper_vpq_compute(
            videos, categories, nf, output_dir=output_dir,
            save_name=save_name,
        )
        all_results[nf] = dict(results, per_class=per_class)
    return all_results
