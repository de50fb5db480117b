"""Synthetic Cityscapes-VPS fixture generator (the port's copy of the JAX
package's ``data/synth.py``: the same files, byte for byte, for the same
arguments).

Scenes are learnable by pixels: stuff bands and thing rectangles are
rendered in their Cityscapes palette colors (plus a stable per-instance
jitter that gives the track head an appearance cue).

Every frame is emitted in both formats the framework consumes:

- training side: ``{mode}/img/*_newImg8bit.png`` RGB frames,
  ``{mode}/labelmap/*_final_mask.png`` trainId semantic maps, and a
  COCO-video ``instances_{mode}.json`` (bbox/polygon/inst_id per thing),
  the CityscapesVPSDataset contract;
- eval side: ``{mode}/cls`` color + ``{mode}/inst`` id pngs in the raw
  format prepare_data/create_panoptic_labels.py expects, so the repo's
  GT-building scripts produce the panoptic-video GT that
  ``vps_torch.tools.eval_vpq`` scores against.

Instances never overlap (disjoint y-bands per slot) and keep a stable
per-class instance index across frames: the GT track identity
create_panoptic_video_labels.py derives from the panoptic_inst value.
"""

from __future__ import annotations

import json
import os
import os.path as osp
import sys
from typing import Dict, List, Tuple

import numpy as np

_PREP = osp.join(osp.dirname(osp.dirname(osp.dirname(osp.abspath(__file__)))),
                 "prepare_data")


def _categories():
    if _PREP not in sys.path:
        sys.path.insert(0, _PREP)
    from city_categories import CATEGORIES  # noqa: E402

    return {c["name"]: c for c in CATEGORIES}


# thing-class CLASSES order of CityscapesVPSDataset (data/dataset.py):
# category_id in instances.json is 1-based index into this tuple
_THING_CLASSES = ("person", "rider", "car", "truck", "bus", "train",
                  "motorcycle", "bicycle")


class _Inst:
    """One thing instance: a rectangle with constant velocity and a stable
    per-instance color jitter (its appearance signature across frames)."""

    def __init__(self, name: str, slot: int, rng, H: int, W: int,
                 n_frames: int, y_band: Tuple[float, float]):
        self.name = name
        self.slot = slot  # per-class instance index, stable across frames
        cat = _categories()[name]
        self.trainid = cat["id"]
        self.ori_id = cat["ori_id"]
        self.color = np.asarray(cat["color"], np.int32)
        self.jit = rng.randint(-45, 46, size=3)
        if name == "person":
            self.w = int(rng.randint(10, 15))
            self.h = int(rng.randint(26, 34))
            vx = int(rng.randint(1, 4)) * (1 if rng.rand() < 0.5 else -1)
        else:  # car
            self.w = int(rng.randint(38, 58))
            self.h = int(rng.randint(20, 30))
            vx = int(rng.randint(5, 11)) * (1 if rng.rand() < 0.5 else -1)
        lo = int(H * y_band[0])
        band_hi = int(H * y_band[1])
        # Clamp height to the band so the disjoint-band invariant holds: at
        # small H the nominal size range can exceed the band.
        self.h = min(self.h, band_hi - lo - 1)
        hi = band_hi - self.h
        self.y = int(rng.randint(lo, hi))
        assert self.y + self.h <= band_hi, (self.y, self.h, band_hi)
        travel = abs(vx) * (n_frames - 1)
        if travel > W - self.w - 4:  # keep fully in-frame for all frames
            vx = int(np.sign(vx)) * max(1, (W - self.w - 4) // max(1, n_frames - 1))
            travel = abs(vx) * (n_frames - 1)
        self.vx = vx
        x_lo = 2 + (travel if vx < 0 else 0)
        x_hi = W - self.w - 2 - (travel if vx > 0 else 0)
        self.x0 = int(rng.randint(x_lo, max(x_lo + 1, x_hi)))

    def box(self, t: int) -> Tuple[int, int, int, int]:
        x = self.x0 + self.vx * t
        return x, self.y, self.w, self.h


def _render(insts: List[_Inst], H: int, W: int, t: int,
            cats: Dict[str, dict], frame_rng):
    """Returns (rgb uint8, semantic trainId map, raw instance-id map)."""
    sem = np.zeros((H, W), np.uint8)
    rgb = np.zeros((H, W, 3), np.float32)
    horizon = int(H * 0.28)
    mid = int(H * 0.55)
    for name, (r0, r1) in (("sky", (0, horizon)), ("building", (horizon, mid)),
                           ("road", (mid, H))):
        c = cats[name]
        sem[r0:r1] = c["id"]
        band = np.asarray(c["color"], np.float32)[None, None]
        # mild vertical gradient so stuff isn't a constant (texture signal)
        g = np.linspace(-12.0, 12.0, r1 - r0, dtype=np.float32)[:, None, None]
        rgb[r0:r1] = band + g
    inst_map = np.zeros((H, W), np.int32)
    for it in insts:
        x, y, w, h = it.box(t)
        rgb[y:y + h, x:x + w] = (it.color + it.jit).astype(np.float32)
        sem[y:y + h, x:x + w] = it.trainid
        inst_map[y:y + h, x:x + w] = it.ori_id * 1000 + it.slot
    rgb += frame_rng.randn(H, W, 3).astype(np.float32) * 6.0
    return np.clip(rgb, 0, 255).astype(np.uint8), sem, inst_map


def make_synth_vps(root: str, mode: str = "val", n_videos: int = 2,
                   n_frames: int = 4, H: int = 128, W: int = 256,
                   seed: int = 0, first_video: int = 1):
    """Generate a synthetic VPS dataset under ``root`` and return
    ``(ann_file, img_dir, seg_dir)`` for CityscapesVPSDataset.

    Videos are named ``{first_video+v:04d}``; each has 2 cars + 1 person in
    disjoint y-bands with constant per-video motion.
    """
    import cv2
    from PIL import Image

    cats = _categories()
    img_dir = osp.join(root, mode, "img")
    seg_dir = osp.join(root, mode, "labelmap")
    cls_dir = osp.join(root, mode, "cls")
    inst_dir = osp.join(root, mode, "inst")
    for d in (img_dir, seg_dir, cls_dir, inst_dir):
        os.makedirs(d, exist_ok=True)

    trainid2color = {c["id"]: c["color"] for c in cats.values()}
    images, annotations = [], []
    ann_id = 1
    for v in range(n_videos):
        vid = first_video + v
        vrng = np.random.RandomState(seed * 1000 + vid)
        # disjoint y-bands: person on the upper road, cars below
        insts = [
            _Inst("person", 0, vrng, H, W, n_frames, (0.50, 0.64)),
            _Inst("car", 0, vrng, H, W, n_frames, (0.64, 0.82)),
            _Inst("car", 1, vrng, H, W, n_frames, (0.82, 1.00)),
        ]
        for t in range(n_frames):
            frame_rng = np.random.RandomState(seed * 100000 + vid * 100 + t)
            rgb, sem, inst_map = _render(insts, H, W, t, cats, frame_rng)
            stem = f"{vid:04d}_{t:04d}_city"
            cv2.imwrite(osp.join(img_dir, stem + "_newImg8bit.png"),
                        rgb[..., ::-1])  # cv2 writes BGR
            cv2.imwrite(osp.join(seg_dir, stem + "_final_mask.png"), sem)
            # raw eval-side GT: color-coded semantic + int32 instance map
            color = np.zeros((H, W, 3), np.uint8)
            for tid, col in trainid2color.items():
                color[sem == tid] = col
            Image.fromarray(color).save(
                osp.join(cls_dir, stem + "_gtFine_color.png"))
            Image.fromarray(inst_map, mode="I").save(
                osp.join(inst_dir, stem + "_gtFine_color.png"))

            image_id = (vid - first_video) * n_frames + t + 1
            images.append(dict(id=image_id,
                               file_name=stem + "_newImg8bit.png",
                               height=H, width=W))
            for it in insts:
                x, y, w, h = it.box(t)
                annotations.append(dict(
                    id=ann_id, image_id=image_id,
                    category_id=_THING_CLASSES.index(it.name) + 1,
                    bbox=[x, y, w, h], area=w * h, iscrowd=0,
                    inst_id=vid * 1000 + it.trainid * 10 + it.slot,
                    segmentation=[[x, y, x + w, y, x + w, y + h, x, y + h]],
                ))
                ann_id += 1
    categories = [dict(id=i + 1, name=n)
                  for i, n in enumerate(_THING_CLASSES)]
    ann = dict(images=images, annotations=annotations, categories=categories)
    ann_file = osp.join(root, f"instances_{mode}.json")
    with open(ann_file, "w") as f:
        json.dump(ann, f)
    return ann_file, img_dir, seg_dir
