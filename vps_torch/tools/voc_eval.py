"""VOC-style box mAP of pickled detection results (the port's counterpart
of the repo's ``tools/voc_eval.py``, with its numbers). As there, the
dataset's ignored boxes (VOC "difficult", under ``min_size``) join the gt
with label 0, which no class reads: they are neither gt nor ignores, and a
detection on one counts as a false positive. mmdet's VOC protocol ignores
them, so on data with difficult boxes this mAP is not the published VOC
mAP.

    python -m vps_torch.tools.voc_eval RESULTS.pkl CONFIG [--iou-thr 0.5]
        [--mode area|11points]

The pickle is coco_eval's: per image, per-class (n, 5) arrays. The
annotations come from the config's ``data.val``. Host numpy only.
"""

from __future__ import annotations

import argparse
import pickle

from vps_torch.config import Config
from vps_torch.data import build_dataset
from vps_torch.eval.mean_ap import eval_map
from vps_torch.tools.coco_eval import dataset_gts


def main(argv=None):
    """Prints the per-class table; returns (mAP, per-class results)."""
    p = argparse.ArgumentParser()
    p.add_argument("results", help="detection results pickle")
    p.add_argument("config")
    p.add_argument("--iou-thr", type=float, default=0.5)
    p.add_argument("--mode", default="area", choices=["area", "11points"])
    args = p.parse_args(argv)

    with open(args.results, "rb") as f:
        det_results = pickle.load(f)
    dataset = build_dataset(Config.fromfile(args.config).data["val"])
    gt_bboxes, gt_labels, gt_ignore = dataset_gts(dataset, with_ignore=True)
    return eval_map(det_results, gt_bboxes, gt_labels, gt_ignore=gt_ignore,
                    iou_thr=args.iou_thr, mode=args.mode,
                    dataset=getattr(dataset, "CLASSES", None))


if __name__ == "__main__":
    main()
