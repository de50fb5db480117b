"""A synthetic dataset in VIPER's format, made from a seed with numpy and
cv2, for the VIPER tests and for ``chip_smoke.py``'s "viper" phase (no VIPER
data is in the repo). It imports numpy, cv2 and ``vps_torch`` only.

Layout under ``root`` (the paths ``vps_torch/configs/viper/fusetrack.py``
names under its data root):

- ``train/img/VVV_TTTTT.jpg`` frames, ``train/labelmap/VVV_TTTTT.png``
  semantic maps (classes 0..22, 255 void), and the COCO-video json
  ``instances_train_05_viper_coco.json`` (bbox, polygon, ``inst_id``; the 10
  thing categories, ids 1..10);
- the same for ``val_day/`` with ``instances_val_day_01_viper_coco.json``;
- the val panoptic GT: ``panoptic_gt_val_viper.json`` (23 categories, ids
  13..22 things; images ``{"id": "VVV_TTTTT", "file_name":
  "VVV_TTTTT.png"}``) and its colour PNGs in ``val_day/panoptic_viper/``,
  encoded video by video with ``encode_panoptic_video``, as VIPER's
  converter does.

Scenes: horizontal stuff bands (sky, building, road) with a void strip at
the bottom, and rectangular things in disjoint horizontal slots moving at a
constant speed, so masks never overlap and each keeps its track id across
a video. Image ids are consecutive within a split, so a training frame's
reference frames (offsets -2..2) are its neighbours in the video.
"""

from __future__ import annotations

import json
import os
import os.path as osp

import numpy as np

# VIPER's 10 thing classes; category id c is semantic class c + 12
THINGS = ("car", "truck", "bus", "train", "moped", "motorcycle", "bicycle",
          "person", "rider", "van")
NUM_CLASSES, NUM_THINGS = 23, 10
NUM_STUFF = NUM_CLASSES - NUM_THINGS
STUFF_BANDS = ((0, 0.3), (3, 0.55), (7, 0.95))  # (class, band's lower edge)
VOID = 255


def categories():
    """The panoptic GT's 23 categories: stuff 0..12, things 13..22."""
    return [dict(id=i, name=(THINGS[i - NUM_STUFF] if i >= NUM_STUFF
                             else f"stuff{i}"),
                 isthing=int(i >= NUM_STUFF),
                 color=[(i * 37 + 29) % 256, (i * 91 + 7) % 256,
                        (i * 173 + 83) % 256])
            for i in range(NUM_CLASSES)]


def _palette():
    rng = np.random.RandomState(1234)
    return rng.randint(30, 226, (NUM_CLASSES, 3)).astype(np.float32)


def _things(rng, h, w, n_frames, n_things=4):
    """n_things moving rectangles, one per horizontal slot of the lower
    part of the frame: (category id, x0, y, bw, bh, vx, colour jitter)."""
    cats = rng.choice(NUM_THINGS, n_things, replace=False) + 1
    top, bottom = int(0.32 * h), int(0.94 * h)
    slot = (bottom - top) // n_things
    out = []
    for i, cat in enumerate(cats):
        bh = max(2, min(slot - 2, int(rng.uniform(0.07, 0.12) * h)))
        bw = max(3, int(rng.uniform(0.08, 0.14) * w))
        y = top + i * slot + int(rng.randint(0, max(1, slot - bh)))
        vx = int(rng.choice([-1, 1]) * max(1, int(rng.uniform(0.005, 0.012) * w)))
        travel = abs(vx) * (n_frames - 1)
        lo = 1 + (travel if vx < 0 else 0)
        hi = w - bw - 1 - (travel if vx > 0 else 0)
        x0 = int(rng.randint(lo, max(lo + 1, hi)))
        out.append((int(cat), x0, y, bw, bh, vx, rng.randint(-40, 41, 3)))
    return out


def _render(things, h, w, t, frame_rng, palette):
    """One frame: (BGR uint8 image, semantic map, track-id map)."""
    sem = np.full((h, w), VOID, np.uint8)
    r0 = 0
    for cls, edge in STUFF_BANDS:
        r1 = int(edge * h)
        sem[r0:r1] = cls
        r0 = r1
    track = np.zeros((h, w), np.uint8)
    rgb = palette[sem.clip(0, NUM_CLASSES - 1)].copy()
    rgb[sem == VOID] = 0
    rgb += np.linspace(-10, 10, h, dtype=np.float32)[:, None, None]
    for k, (cat, x0, y, bw, bh, vx, jit) in enumerate(things):
        x = x0 + vx * t
        sem[y:y + bh, x:x + bw] = cat + NUM_STUFF - 1
        track[y:y + bh, x:x + bw] = k + 1
        rgb[y:y + bh, x:x + bw] = palette[cat + NUM_STUFF - 1] + jit
    rgb += frame_rng.randn(h, w, 3).astype(np.float32) * 6.0
    return np.clip(rgb, 0, 255).astype(np.uint8)[..., ::-1], sem, track


def _split(root, split, ann_name, n_videos, n_frames, h, w, seed,
           first_video, palette):
    """Writes one split's frames, label maps and instance json; returns the
    json path, the image dir and, per video, its frames' (stem, semantic,
    track) maps."""
    import cv2

    img_dir = osp.join(root, split, "img")
    seg_dir = osp.join(root, split, "labelmap")
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(seg_dir, exist_ok=True)
    images, annotations, videos = [], [], []
    for v in range(n_videos):
        vid = first_video + v
        vrng = np.random.RandomState(seed * 1000 + vid)
        things = _things(vrng, h, w, n_frames)
        frames = []
        for t in range(n_frames):
            frng = np.random.RandomState(seed * 100000 + vid * 100 + t)
            bgr, sem, track = _render(things, h, w, t, frng, palette)
            stem = f"{vid:03d}_{t:05d}"
            cv2.imwrite(osp.join(img_dir, stem + ".jpg"), bgr)
            cv2.imwrite(osp.join(seg_dir, stem + ".png"), sem)
            image_id = len(images) + 1
            images.append(dict(id=image_id, file_name=stem + ".jpg",
                               height=h, width=w))
            for k, (cat, x0, y, bw, bh, vx, _) in enumerate(things):
                x = x0 + vx * t
                annotations.append(dict(
                    id=len(annotations) + 1, image_id=image_id,
                    category_id=cat, bbox=[x, y, bw, bh], area=bw * bh,
                    iscrowd=0, inst_id=vid * 100 + k + 1,
                    segmentation=[[x, y, x + bw, y, x + bw, y + bh, x,
                                   y + bh]]))
            frames.append((stem, sem, track))
        videos.append(frames)
    ann_file = osp.join(root, ann_name)
    with open(ann_file, "w") as f:
        json.dump(dict(images=images, annotations=annotations,
                       categories=[dict(id=i + 1, name=n)
                                   for i, n in enumerate(THINGS)]), f)
    return ann_file, img_dir, videos


def make_viper_fixture(root, train_videos=1, train_frames=4, val_videos=2,
                       val_frames=15, h=1080, w=1920, seed=0):
    """Writes the fixture under ``root`` (name it so its path holds
    "viper": VIPER's evaluator reads GT PNGs by basename from such a
    folder). Returns a dict of its paths: train_ann, train_img, train_seg,
    val_ann, val_img, gt_json, gt_dir."""
    import cv2

    from vps_torch.eval.unified import encode_panoptic_video

    palette = _palette()
    train_ann, train_img, _ = _split(
        root, "train", "instances_train_05_viper_coco.json", train_videos,
        train_frames, h, w, seed, 1, palette)
    val_ann, val_img, videos = _split(
        root, "val_day", "instances_val_day_01_viper_coco.json", val_videos,
        val_frames, h, w, seed + 1, 1, palette)
    gt_dir = osp.join(root, "val_day", "panoptic_viper")
    os.makedirs(gt_dir, exist_ok=True)
    cats = categories()
    images, annotations = [], []
    for frames in videos:
        two_ch = []
        for _, sem, track in frames:
            m = np.zeros(sem.shape + (3,), np.uint8)
            m[..., 0], m[..., 2] = sem, track
            two_ch.append(m)
        pans, anns = encode_panoptic_video(two_ch, {c["id"]: c for c in cats})
        for (stem, _, _), pan, ann in zip(frames, pans, anns):
            cv2.imwrite(osp.join(gt_dir, stem + ".png"), pan[..., ::-1])
            images.append(dict(id=stem, file_name=stem + ".png",
                               height=h, width=w))
            annotations.append(dict(ann, image_id=stem,
                                    file_name=stem + ".png"))
    gt_json = osp.join(root, "panoptic_gt_val_viper.json")
    with open(gt_json, "w") as f:
        json.dump(dict(images=images, annotations=annotations,
                       categories=cats), f)
    return dict(train_ann=train_ann, train_img=train_img,
                train_seg=osp.join(root, "train", "labelmap"),
                val_ann=val_ann, val_img=val_img, gt_json=gt_json,
                gt_dir=gt_dir)
