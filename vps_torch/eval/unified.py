"""Per-frame model outputs -> unified 3-channel panoptic maps -> color-id
encoded PNGs + pred.json (the port's copy of the JAX package's
``eval/unified.py``).

The reference's cityscapes_vps tools: ``get_unified_pan_result``
(majority-vote consistency between instance prediction and the semantic
FCN, stuff-area filtering, per-object channel) and
``converter_2ch_track_core`` (2ch -> panopticapi color ids with per-track
color persistence).
"""

from __future__ import annotations

import json
import os
import os.path as osp
from typing import Dict, List, Optional, Sequence

import numpy as np


def get_unified_pan_result(
    segs: Sequence[np.ndarray],
    pans: Sequence[np.ndarray],
    cls_inds: Sequence[np.ndarray],
    obj_ids: Optional[Sequence[np.ndarray]] = None,
    names: Sequence[str] = None,
    stuff_area_limit: int = 4 * 64 * 64,
    num_stuff: int = 11,
) -> Dict[str, np.ndarray]:
    """Build 3-channel maps: ch0 semantic class, ch1 per-frame instance index,
    ch2 track object id (+1). ``pans`` values: 0..num_stuff-1 stuff, 255 void,
    num_stuff+k = instance k; cls_inds[k] are 1-based thing classes."""
    if obj_ids is None:
        obj_ids = [None] * len(cls_inds)
    out: Dict[str, np.ndarray] = {}
    max_oid = 100
    id_last_stuff = num_stuff - 1
    for seg, pan, cls_ind, obj_id, name in zip(segs, pans, cls_inds, obj_ids, names):
        # de-duplicate object ids within the frame (reference :168-180):
        # later duplicates get fresh ids, keeping the LAST occurrence's id
        if obj_id is not None and len(obj_id):
            obj_id = np.asarray(obj_id).copy()
            uniq, cnt = np.unique(obj_id, return_counts=True)
            if np.any(cnt > 1):
                rev = obj_id[::-1].copy()
                for red in uniq[cnt > 1]:
                    part = obj_id[obj_id == red]
                    for i in range(1, len(part)):
                        part[i] = max_oid
                        max_oid += 1
                    rev[rev == red] = part
                obj_id = rev[::-1]

        pan_seg = pan.copy()
        pan_ins = pan.copy()
        pan_obj = pan.copy()
        ids = np.unique(pan)
        ids_ins = ids[ids > id_last_stuff]
        pan_ins[pan_ins <= id_last_stuff] = 0
        for idx, iid in enumerate(ids_ins):
            region = pan_ins == iid
            if iid == 255:
                pan_seg[region] = 255
                pan_ins[region] = 0
                continue
            k = iid - id_last_stuff - 1
            mapped_cls = cls_ind[k] + id_last_stuff
            cls, cnt = np.unique(seg[region], return_counts=True)
            if cls[np.argmax(cnt)] == mapped_cls:
                pan_seg[region] = mapped_cls
                pan_ins[region] = idx + 1
                if obj_id is not None:
                    pan_obj[region] = obj_id[idx] + 1
            else:
                if np.max(cnt) / np.sum(cnt) >= 0.5 and cls[np.argmax(cnt)] <= id_last_stuff:
                    pan_seg[region] = cls[np.argmax(cnt)]
                    pan_ins[region] = 0
                    pan_obj[region] = 0
                else:
                    pan_seg[region] = mapped_cls
                    pan_ins[region] = idx + 1
                    if obj_id is not None:
                        pan_obj[region] = obj_id[idx] + 1

        for sem in np.unique(pan_seg):
            if sem <= id_last_stuff:
                area = pan_seg == sem
                if area.sum() < stuff_area_limit:
                    pan_seg[area] = 255

        pan_2ch = np.zeros((*pan.shape, 3), np.uint8)
        pan_2ch[..., 0] = pan_seg
        pan_2ch[..., 1] = pan_ins
        pan_2ch[..., 2] = pan_obj
        out[name] = pan_2ch
    return out


class ColorGenerator:
    """Deterministic panopticapi-style unique color generator: stuff keeps
    its category color; each thing instance gets a distinct jitter of its
    category color. Ids are r + 256·g + 256²·b."""

    def __init__(self, categories: Dict[int, dict]):
        self.categories = categories
        self.used = set()
        self.rng = np.random.RandomState(0)

    @staticmethod
    def rgb2id(color) -> int:
        return int(color[0]) + 256 * int(color[1]) + 256 * 256 * int(color[2])

    def get_color(self, cat_id: int):
        base = self.categories[cat_id].get("color")
        if base is None:
            base = [(cat_id * 37) % 255, (cat_id * 91) % 255, (cat_id * 173) % 255]
        if self.categories[cat_id].get("isthing", 1) == 0:
            cid = self.rgb2id(base)
            self.used.add(cid)
            return list(base)
        for _ in range(10000):
            color = [
                int(np.clip(c + self.rng.randint(-40, 41), 0, 255)) for c in base
            ]
            cid = self.rgb2id(color)
            if cid not in self.used and cid != 0:
                self.used.add(cid)
                return color
        raise RuntimeError("color space exhausted")


def encode_panoptic_video(
    pan_2ch_list: Sequence[np.ndarray],
    categories: Dict[int, dict],
    num_stuff: int = 11,
):
    """converter_2ch_track_core equivalent for one video: 2ch maps → color
    PNG arrays + segments_info, keeping one color per track id across
    frames. Thing category ids here are semantic indices (ch0), consistent
    with the reference's OFFSET=1000 encoding of (sem, track_id)."""
    OFFSET = 1000
    VOID = 255
    color_gen = ColorGenerator(categories)
    inst2color = {}
    annotations, pan_all = [], []
    for pan_2ch in pan_2ch_list:
        pan_2ch = pan_2ch.astype(np.uint32)
        pan = OFFSET * pan_2ch[..., 0] + pan_2ch[..., 2]
        pan_format = np.zeros((*pan.shape, 3), np.uint8)
        segm_info = {}
        for el in np.unique(pan):
            sem = int(el // OFFSET)
            if sem == VOID:
                continue
            mask = pan == el
            if el % OFFSET > 0:  # thing instance (track id in ch2)
                if el in inst2color:
                    color = inst2color[el]
                else:
                    color = color_gen.get_color(sem)
                    inst2color[el] = color
            else:
                color = color_gen.get_color(sem)
            pan_format[mask] = color
            yy, xx = np.where(mask)
            seg_id = ColorGenerator.rgb2id(color)
            segm_info[seg_id] = {
                "category_id": sem,
                "iscrowd": 0,
                "id": seg_id,
                "bbox": [int(xx.min()), int(yy.min()),
                         int(xx.max() - xx.min()), int(yy.max() - yy.min())],
                "area": int(mask.sum()),
            }
        # recompute areas from the encoded png (reference :143-155)
        ids = (
            pan_format[..., 0].astype(np.uint32)
            + pan_format[..., 1].astype(np.uint32) * 256
            + pan_format[..., 2].astype(np.uint32) * 256 * 256
        )
        labels, cnts = np.unique(ids, return_counts=True)
        for label, area in zip(labels.tolist(), cnts.tolist()):
            if label == 0:
                continue
            if label not in segm_info:
                raise KeyError(f"label {label} missing from segm_info")
            segm_info[label]["area"] = int(area)
        annotations.append({"segments_info": list(segm_info.values())})
        pan_all.append(pan_format)
    return pan_all, annotations


def save_panoptic_outputs(
    pred_pans_2ch: Dict[str, np.ndarray],
    categories: Dict[int, dict],
    output_dir: str,
    lambda_: int = 5,
    labeled_fid: int = 20,
    nframes_per_video: int = 6,
):
    """inference_panoptic_video equivalent: subsample annotated frames,
    encode per video, write pan_pred/*.png + pred.json."""
    import cv2

    names = sorted(pred_pans_2ch.keys())
    names = names[(labeled_fid // lambda_) :: lambda_]
    arrays = [pred_pans_2ch[n] for n in names]

    annotations, pans = [], []
    for i in range(0, len(arrays), nframes_per_video):
        pan_all, anns = encode_panoptic_video(
            arrays[i : i + nframes_per_video], categories
        )
        pans.extend(pan_all)
        annotations.extend(anns)

    pan_dir = osp.join(output_dir, "pan_pred")
    os.makedirs(pan_dir, exist_ok=True)
    out_names = []
    for name, pan in zip(names, pans):
        out_name = (
            name.replace("_leftImg8bit", "").replace("_newImg8bit", "")
            .replace("jpg", "png").replace("jpeg", "png")
        )
        cv2.imwrite(osp.join(pan_dir, out_name), pan[..., ::-1])  # RGB→BGR
        out_names.append(out_name)
    with open(osp.join(output_dir, "pred.json"), "w") as f:
        json.dump({"annotations": annotations}, f)
    return out_names, annotations
