"""Minimal COCO-json index (image/annotation lookup) and annotation masks,
with the numpy decoder of COCO's compressed RLE (the port's copy of the JAX
package's ``data/coco.py`` and of its numpy RLE fallback; the C++ host
library is not ported)."""

from __future__ import annotations

import json
from collections import defaultdict
from typing import Any, Dict, List

import numpy as np

try:
    import cv2
except ImportError:  # pragma: no cover
    cv2 = None


class CocoIndex:
    def __init__(self, ann_file: str):
        with open(ann_file) as f:
            data = json.load(f)
        self.dataset = data
        self.imgs: Dict[int, Dict] = {img["id"]: img for img in data.get("images", [])}
        self.img_ids: List[int] = [img["id"] for img in data.get("images", [])]
        self.cats = {c["id"]: c for c in data.get("categories", [])}
        self.cat_ids = [c["id"] for c in data.get("categories", [])]
        self.img_to_anns = defaultdict(list)
        for ann in data.get("annotations", []):
            self.img_to_anns[ann["image_id"]].append(ann)

    def load_img(self, img_id: int) -> Dict[str, Any]:
        return self.imgs[img_id]

    def load_anns(self, img_id: int) -> List[Dict[str, Any]]:
        return self.img_to_anns.get(img_id, [])


def _runs_to_mask(cnts, h: int, w: int) -> np.ndarray:
    flat = np.zeros(h * w, np.uint8)
    pos = 0
    v = 0
    for n in cnts:
        flat[pos : pos + int(n)] = v
        pos += int(n)
        v = 1 - v
    return flat.reshape(w, h).T  # column-major


def rle_decode(counts, h: int, w: int) -> np.ndarray:
    """Decode a compressed RLE string (COCO wire format: column-major runs,
    6-bit chars, delta coding) or an uncompressed counts list into an
    (h, w) uint8 mask."""
    if isinstance(counts, (list, tuple)):  # uncompressed RLE
        return _runs_to_mask(counts, h, w)
    if isinstance(counts, bytes):
        counts = counts.decode("ascii")
    cnts = []
    p = 0
    while p < len(counts):
        x = 0
        k = 0
        more = True
        while more:
            c = ord(counts[p]) - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            p += 1
            k += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * k)
        if len(cnts) > 2:
            x += cnts[-2]
        cnts.append(x)
    return _runs_to_mask(cnts, h, w)


def ann_to_mask(segm, h: int, w: int) -> np.ndarray:
    """Decode a segmentation annotation (polygon list, uncompressed RLE dict,
    or compressed RLE dict) to an (h, w) uint8 mask."""
    if isinstance(segm, list):  # polygons
        mask = np.zeros((h, w), np.uint8)
        if cv2 is None:
            raise RuntimeError("cv2 required for polygon masks")
        for poly in segm:
            pts = np.asarray(poly, np.float64).reshape(-1, 2)
            cv2.fillPoly(mask, [np.round(pts).astype(np.int32)], 1)
        return mask
    counts = segm["counts"]
    hh, ww = segm.get("size", (h, w))
    return rle_decode(counts, int(hh), int(ww))
