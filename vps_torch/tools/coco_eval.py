"""COCO-protocol box AP of pickled detection results (the port's
counterpart of the repo's ``tools/coco_eval.py``): the VOC-style AP of
``vps_torch.eval.mean_ap.eval_map`` at the IoU thresholds 0.50:0.05:0.95,
and their mean, against the annotations of the config's dataset.

    python -m vps_torch.tools.coco_eval RESULTS.pkl CONFIG [--split val]

The pickle is a list over the dataset's images of per-class (n, 5) arrays
(x1, y1, x2, y2, score) in the image's own coordinates. Host numpy only.
"""

from __future__ import annotations

import argparse
import pickle

import numpy as np

from vps_torch.config import Config
from vps_torch.data import build_dataset
from vps_torch.eval.mean_ap import eval_map


def dataset_gts(dataset, with_ignore=False):
    """Per image: the gt boxes (n, 4) float32 and 1-based labels (n,)
    int64 of ``get_ann_info``; ``with_ignore`` appends its
    ``bboxes_ignore`` with label 0 and returns the per-image ignore flags
    as a third list."""
    gt_bboxes, gt_labels, gt_ignore = [], [], []
    for i in range(len(dataset)):
        ann = dataset.get_ann_info(i)
        bboxes = np.asarray(ann["bboxes"], np.float32).reshape(-1, 4)
        labels = np.asarray(ann["labels"], np.int64)
        ignore = np.zeros(len(labels), bool)
        if with_ignore and len(ann.get("bboxes_ignore", ())):
            big = np.asarray(ann["bboxes_ignore"], np.float32).reshape(-1, 4)
            bboxes = np.vstack([bboxes, big])
            labels = np.concatenate([labels, np.zeros(len(big), np.int64)])
            ignore = np.concatenate([ignore, np.ones(len(big), bool)])
        gt_bboxes.append(bboxes)
        gt_labels.append(labels)
        gt_ignore.append(ignore)
    if with_ignore:
        return gt_bboxes, gt_labels, gt_ignore
    return gt_bboxes, gt_labels


def main(argv=None):
    """Returns {"AP@0.50": ..., ..., "AP@0.95": ..., "AP@[0.50:0.95]": ...}."""
    p = argparse.ArgumentParser()
    p.add_argument("results", help="detection results pickle")
    p.add_argument("config")
    p.add_argument("--split", default="val")
    args = p.parse_args(argv)

    with open(args.results, "rb") as f:
        det_results = pickle.load(f)
    dataset = build_dataset(Config.fromfile(args.config).data[args.split])
    gt_bboxes, gt_labels = dataset_gts(dataset)
    classes = getattr(dataset, "CLASSES", None)
    out = {}
    for thr in np.arange(0.5, 1.0, 0.05):
        m, _ = eval_map(det_results, gt_bboxes, gt_labels, iou_thr=float(thr),
                        dataset=classes, print_summary=False)
        out[f"AP@{thr:.2f}"] = m
        print(f"AP@{thr:.2f}: {m:.4f}")
    out["AP@[0.50:0.95]"] = float(np.mean(list(out.values())))
    print(f"AP@[0.50:0.95]: {out['AP@[0.50:0.95]']:.4f}")
    return out


if __name__ == "__main__":
    main()
