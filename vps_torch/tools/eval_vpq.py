"""VPQ scoring (the port's counterpart of the repo's ``tools/eval_vpq.py``):
reads ``pan_pred/*.png`` + ``pred.json`` from ``vps_torch.tools.test_vpq``
and the panoptic GT, writes ``vpq-{0,5,10,15}.txt`` and ``vpq-final.txt``
into the submission dir and prints the ``vpq_all / vpq_thing / vpq_stuff``
line.

    python -m vps_torch.tools.eval_vpq --submit_dir D --truth_dir G
        --pan_gt_json_file gt.json [--nframes_per_video 6]
"""

from __future__ import annotations

import argparse
import json
import os.path as osp
import time

from vps_torch.eval.vpq import vpq_eval_all
from vps_torch.utils.numerics import describe, f32_policy

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
    """Returns (vpq_all, vpq_thing, vpq_stuff)."""
    p = argparse.ArgumentParser()
    p.add_argument("--submit_dir", required=True)
    p.add_argument("--truth_dir", required=True)
    p.add_argument("--pan_gt_json_file", required=True)
    p.add_argument("--nframes_per_video", type=int, default=6)
    args = p.parse_args(argv)
    numerics = f32_policy()

    with open(osp.join(args.submit_dir, "pred.json")) as f:
        pred_jsons = json.load(f)["annotations"]
    with open(args.pan_gt_json_file) as f:
        gt_data = json.load(f)
    categories = {c["id"]: c for c in gt_data["categories"]}
    gt_jsons = gt_data["annotations"]
    gt_images = gt_data["images"]

    t0 = time.time()
    gt_files = sorted(
        item["file_name"].replace("_newImg8bit.png", "_final_mask.png")
        .replace("_leftImg8bit.png", "_gtFine_color.png")
        for item in gt_images
    )
    gt_pans = [_read_rgb(osp.join(args.truth_dir, f)) for f in gt_files]
    pred_files = [item["id"] + ".png" for item in gt_images]
    pred_pans = [
        _read_rgb(osp.join(args.submit_dir, "pan_pred", f)) for f in pred_files
    ]
    print(f"loaded {len(gt_pans)} frames in {time.time() - t0:.1f}s")
    if len(pred_jsons) != len(gt_jsons):
        raise ValueError(f"pred.json has {len(pred_jsons)} frames, the GT "
                         f"{len(gt_jsons)}")

    nf = args.nframes_per_video
    frames = list(zip(gt_jsons, pred_jsons, gt_pans, pred_pans))
    videos = [frames[i : i + nf] for i in range(0, len(frames), nf)]

    final = vpq_eval_all(videos, categories, output_dir=args.submit_dir)
    print("vpq_all: %.4f  vpq_thing: %.4f  vpq_stuff: %.4f" % final)
    print(describe(numerics))
    return final


if __name__ == "__main__":
    main()
