"""COCO error analysis (the port's counterpart of the repo's
``tools/coco_error_analysis.py``, mmdet's tool of that name): per category,
stacked precision-recall curves that split the error budget into C75 / C50
/ Loc / Sim / Oth / BG / FN, computed on the greedy tp/fp matcher of
``vps_torch.eval.mean_ap`` (the one the mAP tools use):

  C75  precision at IoU .75
  C50  precision at IoU .50
  Loc  precision at IoU .10 (localization errors forgiven)
  Sim  IoU .10 with same-supercategory confusions ignored
  Oth  IoU .10 with ALL cross-category confusions ignored
  BG   1 wherever Oth is positive (background false positives removed)
  FN   1 (what remains is missed detections)

Inputs are plain json: COCO-format detections [{image_id, category_id,
bbox [x, y, w, h], score}] and a COCO instances GT.

    python -m vps_torch.tools.coco_error_analysis RESULTS.json OUT_DIR
        --ann ANN.json [--types bbox] [--no-plots]

Writes ``OUT_DIR/{type}/error_analysis.json`` with the per-class AP of every
error type, and without ``--no-plots`` the stacked curves
``OUT_DIR/{type}/{type}-{class}-{area}.png`` (matplotlib, imported only
then). Host numpy only.
"""

from __future__ import annotations

import argparse
import json
import os
import os.path as osp
from typing import Dict, List

import numpy as np

from vps_torch.eval.mean_ap import tpfp_default

AREA_RANGES = {
    "allarea": (0.0, float(1e10)),
    "small": (0.0, 32.0 ** 2),
    "medium": (32.0 ** 2, 96.0 ** 2),
    "large": (96.0 ** 2, float(1e10)),
}
TYPES = ["C75", "C50", "Loc", "Sim", "Oth", "BG", "FN"]
REC_THRS = np.linspace(0.0, 1.0, 101)


def _xywh_to_xyxy(b):
    b = np.asarray(b, np.float32).reshape(-1, 4)
    return np.stack(
        [b[:, 0], b[:, 1], b[:, 0] + b[:, 2], b[:, 1] + b[:, 3]], axis=-1)


def pr_curve(dets_by_img: Dict[int, np.ndarray],
             gts_by_img: Dict[int, np.ndarray],
             ign_by_img: Dict[int, np.ndarray],
             iou_thr: float, area_rng) -> np.ndarray:
    """COCO-style interpolated precision at the 101 recall thresholds.

    dets_by_img: image_id -> (D, 5) xyxy+score; gts_by_img: (G, 4) xyxy;
    ign_by_img: (G,) bool — matches to these absorb detections silently
    (cross-category / out-of-area-range gts). Unmatched detections whose
    own area falls outside area_rng are excluded from the fp count, the
    COCOeval dtIgnore rule.
    """
    scores, tps, fps = [], [], []
    num_gts = 0
    lo, hi = area_rng
    for img_id, gts in gts_by_img.items():
        dets = dets_by_img.get(img_id, np.zeros((0, 5), np.float32))
        ign = ign_by_img[img_id].copy()
        if gts.shape[0]:
            areas = (gts[:, 2] - gts[:, 0]) * (gts[:, 3] - gts[:, 1])
            ign |= (areas < lo) | (areas >= hi)
        num_gts += int((~ign).sum())
        tp, fp = tpfp_default(dets, gts, gt_ignore=ign, iou_thr=iou_thr)
        tp = np.asarray(tp).astype(bool).reshape(-1)
        fp = np.asarray(fp).astype(bool).reshape(-1)
        # dtIgnore: an unmatched det outside the area range is neither
        d_areas = ((dets[:, 2] - dets[:, 0]) * (dets[:, 3] - dets[:, 1])
                   if dets.shape[0] else np.zeros((0,), np.float32))
        out = (d_areas < lo) | (d_areas >= hi)
        fp = fp & ~(out & ~tp)
        scores.append(dets[:, 4])
        tps.append(tp)
        fps.append(fp)
    scores = np.concatenate(scores) if scores else np.zeros((0,))
    tps = np.concatenate(tps).astype(np.float64)
    fps = np.concatenate(fps).astype(np.float64)
    order = np.argsort(-scores)
    tp_cum = np.cumsum(tps[order])
    fp_cum = np.cumsum(fps[order])
    if num_gts == 0:
        return np.zeros_like(REC_THRS)
    rec = tp_cum / num_gts
    prec = tp_cum / np.maximum(tp_cum + fp_cum, 1e-9)
    # precision envelope (monotone non-increasing), sampled at REC_THRS
    for i in range(prec.shape[0] - 1, 0, -1):
        prec[i - 1] = max(prec[i - 1], prec[i])
    idx = np.searchsorted(rec, REC_THRS, side="left")
    out = np.zeros_like(REC_THRS)
    valid = idx < prec.shape[0]
    out[valid] = prec[idx[valid]]
    return out


def analyze_results(res_file: str, ann_file: str, res_types: List[str],
                    out_dir: str, plots: bool = True):
    """Writes each type's error_analysis.json (and its plots); returns
    {type: {class name or "allclass": {error type: {area: AP}}}}."""
    for t in res_types:
        if t != "bbox":
            raise SystemExit(
                f"result type {t!r} unsupported: the analysis matches boxes "
                "(a segm mode needs the mask IoU of pycocotools)")
    with open(ann_file) as f:
        gt = json.load(f)
    with open(res_file) as f:
        results = json.load(f)

    cats = {c["id"]: c for c in gt["categories"]}
    img_ids = [im["id"] for im in gt["images"]]
    # per (cat, img) gt boxes
    gt_by_cat_img = {c: {i: [] for i in img_ids} for c in cats}
    for a in gt["annotations"]:
        if a.get("ignore", 0):
            continue
        gt_by_cat_img[a["category_id"]][a["image_id"]].append(
            dict(box=_xywh_to_xyxy(a["bbox"])[0],
                 iscrowd=bool(a.get("iscrowd", 0))))
    det_by_cat_img = {c: {i: [] for i in img_ids} for c in cats}
    for r in results:
        if r["category_id"] in det_by_cat_img \
                and r["image_id"] in det_by_cat_img[r["category_id"]]:
            det_by_cat_img[r["category_id"]][r["image_id"]].append(
                np.concatenate([_xywh_to_xyxy(r["bbox"])[0],
                                [r["score"]]]))

    def pack_dets(cat):
        return {
            i: (np.stack(v) if v else np.zeros((0, 5), np.float32))
            for i, v in det_by_cat_img[cat].items()
        }

    def pack_gts(cat, extra_ignore_cats=()):
        """GTs of `cat` plus — as pure ignore rows — the GTs of
        extra_ignore_cats (mmdet's tool rewrites their category_id and
        sets ignore=1)."""
        gts, ign = {}, {}
        for i in img_ids:
            rows = [(g["box"], g["iscrowd"])
                    for g in gt_by_cat_img[cat][i]]
            rows += [(g["box"], True)
                     for c2 in extra_ignore_cats
                     for g in gt_by_cat_img[c2][i]]
            if rows:
                gts[i] = np.stack([r[0] for r in rows])
                ign[i] = np.asarray([r[1] for r in rows], bool)
            else:
                gts[i] = np.zeros((0, 4), np.float32)
                ign[i] = np.zeros((0,), bool)
        return gts, ign

    os.makedirs(out_dir, exist_ok=True)
    summaries = {}
    for res_type in res_types:
        type_dir = osp.join(out_dir, res_type)
        os.makedirs(type_dir, exist_ok=True)
        summary = {}
        all_ps = []  # (cat, type, area, 101)
        for cat_id, cat in cats.items():
            dets = pack_dets(cat_id)
            gts, ign = pack_gts(cat_id)
            same_super = [
                c2 for c2, cc in cats.items()
                if c2 != cat_id and cc.get("supercategory")
                == cat.get("supercategory")
            ]
            other = [c2 for c2 in cats if c2 != cat_id]
            gts_sim, ign_sim = pack_gts(cat_id, same_super)
            gts_oth, ign_oth = pack_gts(cat_id, other)

            cat_ps = np.zeros((7, len(AREA_RANGES), 101))
            for ai, (aname, rng) in enumerate(AREA_RANGES.items()):
                c75 = pr_curve(dets, gts, ign, 0.75, rng)
                c50 = pr_curve(dets, gts, ign, 0.50, rng)
                loc = pr_curve(dets, gts, ign, 0.10, rng)
                sim = pr_curve(dets, gts_sim, ign_sim, 0.10, rng)
                oth = pr_curve(dets, gts_oth, ign_oth, 0.10, rng)
                bg = (oth > 0).astype(np.float64)
                fn = np.ones_like(bg)
                cat_ps[:, ai] = np.stack([c75, c50, loc, sim, oth, bg, fn])
            all_ps.append(cat_ps)
            summary[cat["name"]] = {
                t: {a: float(cat_ps[ti, ai].mean())
                    for ai, a in enumerate(AREA_RANGES)}
                for ti, t in enumerate(TYPES)
            }
            if plots:
                for ai, aname in enumerate(AREA_RANGES):
                    _makeplot(cat_ps[:, ai],
                              f"{res_type}-{cat['name']}-{aname}", type_dir)
        mean_ps = np.mean(np.stack(all_ps), axis=0)
        summary["allclass"] = {
            t: {a: float(mean_ps[ti, ai].mean())
                for ai, a in enumerate(AREA_RANGES)}
            for ti, t in enumerate(TYPES)
        }
        if plots:
            for ai, aname in enumerate(AREA_RANGES):
                _makeplot(mean_ps[:, ai], f"{res_type}-allclass-{aname}",
                          type_dir)
        out_json = osp.join(type_dir, "error_analysis.json")
        with open(out_json, "w") as f:
            json.dump(summary, f, indent=1)
        print(f"wrote {out_json}")
        a = summary["allclass"]
        print("allclass AP (allarea): "
              + "  ".join(f"{t}={a[t]['allarea']:.3f}" for t in TYPES))
        summaries[res_type] = summary
    return summaries


def _makeplot(ps, title, out_dir):
    """The stacked-area PR figure of one class and area range."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    cs = np.vstack([
        np.ones((2, 3)),
        np.array([0.31, 0.51, 0.74]),
        np.array([0.75, 0.31, 0.30]),
        np.array([0.36, 0.90, 0.38]),
        np.array([0.50, 0.39, 0.64]),
        np.array([1.0, 0.6, 0.0]),
    ])
    aps = [p.mean() for p in ps]
    curves = [np.zeros_like(REC_THRS)] + [p for p in ps]
    fig = plt.figure()
    ax = plt.subplot(111)
    for k in range(len(TYPES)):
        ax.plot(REC_THRS, curves[k + 1], color=[0, 0, 0], linewidth=0.5)
        ax.fill_between(REC_THRS, curves[k], curves[k + 1], color=cs[k],
                        label=f"[{aps[k]:.3f}]{TYPES[k]}")
    plt.xlabel("recall")
    plt.ylabel("precision")
    plt.xlim(0, 1.0)
    plt.ylim(0, 1.0)
    plt.title(title)
    plt.legend()
    fig.savefig(osp.join(out_dir, f"{title}.png"))
    plt.close(fig)


def main(argv=None):
    """Returns analyze_results' summaries."""
    p = argparse.ArgumentParser(description="COCO Error Analysis Tool")
    p.add_argument("result", help="detections json (COCO format)")
    p.add_argument("out_dir", help="dir for curves + error_analysis.json")
    p.add_argument("--ann", required=True, help="COCO instances GT json")
    p.add_argument("--types", type=str, nargs="+", default=["bbox"])
    p.add_argument("--no-plots", action="store_true",
                   help="numbers only (skip matplotlib pngs)")
    args = p.parse_args(argv)
    return analyze_results(args.result, args.ann, args.types, args.out_dir,
                           plots=not args.no_plots)


if __name__ == "__main__":
    main()
