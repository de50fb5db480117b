"""Image-level Panoptic Quality (the port's counterpart of the repo's
``tools/eval_ipq.py``): PQ is VPQ with a one-frame window. Reads the same
``pan_pred/*.png`` + ``pred.json`` artifacts as ``vps_torch.tools.eval_vpq``
and writes ``vpq-0.txt`` into the submission dir.

    python -m vps_torch.tools.eval_ipq --submit_dir D --truth_dir G
        --pan_gt_json_file gt.json
"""

from __future__ import annotations

import argparse
import json
import os.path as osp

from vps_torch.eval.vpq import vpq_compute

try:
    import cv2
except ImportError:  # pragma: no cover
    cv2 = None


def _read_rgb(path):
    img = cv2.imread(path, cv2.IMREAD_COLOR)
    if img is None:
        raise FileNotFoundError(path)
    return img[..., ::-1]  # BGR -> RGB


def main(argv=None):
    """Returns (pq_all, pq_thing, pq_stuff)."""
    p = argparse.ArgumentParser()
    p.add_argument("--submit_dir", required=True)
    p.add_argument("--truth_dir", required=True)
    p.add_argument("--pan_gt_json_file", required=True)
    args = p.parse_args(argv)

    with open(osp.join(args.submit_dir, "pred.json")) as f:
        pred_jsons = json.load(f)["annotations"]
    with open(args.pan_gt_json_file) as f:
        gt_data = json.load(f)
    categories = {c["id"]: c for c in gt_data["categories"]}
    gt_jsons = gt_data["annotations"]
    gt_images = gt_data["images"]

    gt_files = sorted(
        item["file_name"].replace("_newImg8bit.png", "_final_mask.png")
        .replace("_leftImg8bit.png", "_gtFine_color.png")
        for item in gt_images
    )
    gt_pans = [_read_rgb(osp.join(args.truth_dir, f)) for f in gt_files]
    pred_pans = [
        _read_rgb(osp.join(args.submit_dir, "pan_pred", item["id"] + ".png"))
        for item in gt_images
    ]
    # PQ: every frame its own "video", window 1
    videos = [[fr] for fr in zip(gt_jsons, pred_jsons, gt_pans, pred_pans)]
    final = vpq_compute(videos, categories, nframes=1,
                        output_dir=args.submit_dir)
    print("pq_all: %.4f  pq_thing: %.4f  pq_stuff: %.4f" % final)
    return final


if __name__ == "__main__":
    main()
