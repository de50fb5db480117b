"""The corruption-robustness benchmark (the port's counterpart of the repo's
``tools/test_robustness.py``, mmdet's tool of that name): the test set's
frames through the detector clean and under image corruptions x
severities, each run scored by box mAP (``vps_torch.eval.mean_ap``)
against the dataset's annotations, with the mean detections and frames/s.
Summarise the report with ``vps_torch.tools.robustness_eval``.

    python -m vps_torch.tools.test_robustness CONFIG --checkpoint CKPT
        --out DIR [--corruptions gaussian_noise fog ...|benchmark|noise|
        blur|weather|digital] [--severities 1 3 5] [--max_frames 30]
        [--track_cap 256] [--device cuda|cpu]

Each frame is corrupted in raw-intensity space and renormalised: the image
with the seed of its index, its reference frame with the index + 10000
(``vps_torch.data.corruptions``, host numpy). A video's first frame clears
the track state; every frame computes its reference pyramid from its own
(corrupted) reference frame. Writes ``DIR/robustness.json``: per run
("clean", "<corruption>_s<severity>") the frames, mean detections,
``bbox_mAP`` and frames/s. Runs on the card unless ``--device cpu``, under
``inference_policy`` (TF32 off, cuDNN deterministic).
"""

from __future__ import annotations

import argparse
import json
import os
import os.path as osp
import sys
import time

import numpy as np
import torch

from vps_torch import resolve_device
from vps_torch.config import Config
from vps_torch.data import build_dataset
from vps_torch.data.corruptions import BENCHMARK_CORRUPTIONS, corrupt
from vps_torch.data.transforms import IMG_MEAN, IMG_STD
from vps_torch.eval.mean_ap import eval_map
from vps_torch.models.builder import build_detector
from vps_torch.models.detectors import empty_track_state
from vps_torch.utils.checkpoint import load_checkpoint
from vps_torch.utils.numerics import describe, inference_policy

GROUPS = {
    "benchmark": BENCHMARK_CORRUPTIONS,
    "noise": ["gaussian_noise", "shot_noise", "impulse_noise"],
    "blur": ["defocus_blur", "gaussian_blur", "motion_blur", "zoom_blur"],
    "weather": ["snow", "frost", "fog", "brightness"],
    "digital": ["contrast", "elastic_transform", "pixelate",
                "jpeg_compression"],
}


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("config")
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--out", required=True, help="output directory")
    p.add_argument("--corruptions", nargs="+", default=BENCHMARK_CORRUPTIONS,
                   help="corruption names or a group: " + ", ".join(GROUPS))
    p.add_argument("--severities", type=int, nargs="+", default=[1, 3, 5])
    p.add_argument("--max_frames", type=int, default=0,
                   help="cap evaluated frames (0 = all)")
    p.add_argument("--track_cap", type=int, default=256)
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def corrupt_normalised(img, name, severity, seed):
    """A normalised (H, W, 3) frame corrupted in raw-intensity space and
    normalised again, float32."""
    raw = corrupt(img * IMG_STD + IMG_MEAN, name, severity, seed=seed)
    return ((raw - IMG_MEAN) / IMG_STD).astype(np.float32)


def det_lists(out, num_fg, scale_factor):
    """Per-class (n, 5) float32 arrays (x1, y1, x2, y2, score) of the valid
    detections in the frame's own coordinates; ``det_bboxes`` carries the
    score column, or ``det_probs`` gives it. ``det_labels`` is 0-based:
    class c of the list is label c + 1 of eval_map's gt."""
    valid = out["det_valid"].cpu().numpy().astype(bool)
    boxes = out["det_bboxes"].cpu().numpy().astype(np.float32)[valid]
    if boxes.shape[1] == 4:
        probs = out["det_probs"].cpu().numpy().astype(np.float32)[valid]
        boxes = np.concatenate([boxes, probs[:, None]], axis=-1)
    boxes[:, :4] /= np.float32(scale_factor)
    labels = out["det_labels"].cpu().numpy()[valid]
    return [boxes[labels == c] for c in range(num_fg)]


def main(argv=None):
    """Returns dict(report: robustness.json's runs, det_results: each run's
    per-frame detection lists, corrupt_s: each run's host seconds of
    corruption a frame, numerics)."""
    args = parse_args(argv)
    with inference_policy() as numerics:
        return _main(args, numerics)


def _main(args, numerics):
    device = resolve_device(args.device)
    cfg = Config.fromfile(args.config)
    det = build_detector(cfg.model, cfg.train_cfg, cfg.test_cfg, device)
    restored = load_checkpoint(args.checkpoint,
                               {"state_dict": det.state_dict()})
    det.load_state_dict(restored["state_dict"])
    dataset = build_dataset(cfg.data["test"])
    n_frames = (len(dataset) if args.max_frames == 0
                else min(len(dataset), args.max_frames))
    corruptions = [c for name in args.corruptions
                   for c in GROUPS.get(name, [name])]
    shape_nopad = tuple(dataset.prepare_test(0)[2]["img_shape_withoutpad"])
    num_fg = cfg.model["bbox_head"]["num_classes"] - 1
    gt_bboxes, gt_labels = [], []
    for idx in range(n_frames):
        ann = dataset.get_ann_info(idx)
        gt_bboxes.append(np.asarray(ann["bboxes"], np.float32))
        gt_labels.append(np.asarray(ann["labels"], np.int64))

    os.makedirs(args.out, exist_ok=True)
    report, det_results, corrupt_s = {}, {}, {}
    runs = [("clean", 0)] + [(c, s) for c in corruptions for s in args.severities]
    for cname, severity in runs:
        key = f"{cname}_s{severity}" if severity else "clean"
        state = empty_track_state(args.track_cap, device=device)
        counts, dets, host = [], [], 0.0
        t0 = time.perf_counter()
        for idx in range(n_frames):
            img, ref_img, meta = dataset.prepare_test(idx)
            if severity:
                tc = time.perf_counter()
                img = corrupt_normalised(img, cname, severity, idx)
                ref_img = corrupt_normalised(ref_img, cname, severity,
                                             idx + 10000)
                host += time.perf_counter() - tc
            if meta["is_first"]:
                state = empty_track_state(args.track_cap, device=device)
            out, state = det.predict(
                torch.as_tensor(img, device=device)[None],
                torch.as_tensor(ref_img, device=device)[None], state,
                img_shape_withoutpad=shape_nopad)
            counts.append(int(out["num_keep"]))
            dets.append(det_lists(out, num_fg, meta.get("scale_factor", 1.0)))
        dt = time.perf_counter() - t0
        mean_ap, _ = eval_map(dets, gt_bboxes, gt_labels, print_summary=False)
        report[key] = dict(frames=n_frames,
                           mean_detections=float(np.mean(counts)),
                           bbox_mAP=float(mean_ap), fps=n_frames / dt)
        det_results[key] = dets
        corrupt_s[key] = host / n_frames
        print(f"{key}: {report[key]}, corruption {corrupt_s[key]:.4f} s a "
              f"frame (host, image and reference)", file=sys.stderr)

    with open(osp.join(args.out, "robustness.json"), "w") as f:
        json.dump(report, f, indent=2)
    print(f"test_robustness: {len(runs)} runs of {n_frames} frames on "
          f"{device}; {describe(numerics)}", file=sys.stderr)
    print(json.dumps(report))
    return dict(report=report, det_results=det_results, corrupt_s=corrupt_s,
                numerics=numerics)


if __name__ == "__main__":
    main()
