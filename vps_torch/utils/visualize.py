"""Detection and panoptic drawing (the port's copy of the JAX package's
``utils/visualize.py``): the surface mmdet's ``BaseDetector.show_result`` +
``mmcv.imshow_det_bboxes`` and UPSNet's ``colormap`` give the reference.

Drawing is host-side numpy/cv2: the detector hands back fixed-capacity
arrays (``det_bboxes`` (D, 4|5), ``det_labels`` (D,), ``num_keep``) and the
valid prefix is sliced here. The palette is generated (golden-angle hue
steps, consecutive colours far apart for any N), not a vendored table.
"""

from __future__ import annotations

import colorsys
from typing import Optional, Sequence

import numpy as np

try:
    import cv2
except Exception:  # pragma: no cover - cv2 is in the image; keep importable
    cv2 = None

_GOLDEN = 0.61803398875


def palette(n: int, sat: float = 0.65, val: float = 0.95,
            bgr: bool = False) -> np.ndarray:
    """(n, 3) uint8 RGB (or BGR) colors; consecutive entries are far apart in
    hue (golden-angle stepping), so adjacent instance ids stay visually
    distinct. Deterministic: palette(n)[:k] == palette(k)."""
    cols = np.empty((n, 3), np.uint8)
    h = 0.0
    for i in range(n):
        r, g, b = colorsys.hsv_to_rgb(h % 1.0, sat, val)
        cols[i] = (int(r * 255), int(g * 255), int(b * 255))
        h += _GOLDEN
    return cols[:, ::-1] if bgr else cols


def colormap(rgb: bool = True) -> np.ndarray:
    """UPSNet's ``colormap`` entry point: a (79, 3) float palette in
    [0, 255]. Same shape and contract, generated colours."""
    return palette(79).astype(np.float64) if rgb else palette(
        79, bgr=True).astype(np.float64)


def draw_detections(
    img: np.ndarray,
    bboxes: np.ndarray,
    labels: np.ndarray,
    masks: Optional[np.ndarray] = None,
    class_names: Optional[Sequence[str]] = None,
    score_thr: float = 0.3,
    num_keep: Optional[int] = None,
    thickness: int = 1,
    font_scale: float = 0.5,
    out_file: Optional[str] = None,
) -> np.ndarray:
    """Draw boxes (k,4) or (k,5 with score), labels (k,), optional full-image
    boolean masks (k,H,W) onto ``img`` (H,W,3 uint8, RGB). Returns the drawn
    copy; writes ``out_file`` (BGR, like cv2 convention) when given.

    The surface of mmcv.imshow_det_bboxes + the mask-blend loop of mmdet's
    BaseDetector.show_result, the masks blended in one composite.
    """
    if cv2 is None:  # pragma: no cover
        raise RuntimeError("cv2 unavailable")
    img = np.ascontiguousarray(img.copy())
    bboxes = np.asarray(bboxes, np.float32).reshape(-1, bboxes.shape[-1])
    labels = np.asarray(labels).reshape(-1)
    k = len(bboxes) if num_keep is None else int(num_keep)
    bboxes, labels = bboxes[:k], labels[:k]
    if bboxes.shape[-1] == 5:
        keep = bboxes[:, 4] >= score_thr
        bboxes, labels = bboxes[keep], labels[keep]
        if masks is not None:
            masks = np.asarray(masks)[:k][keep]
    elif masks is not None:
        masks = np.asarray(masks)[:k]
    cols = palette(max(int(labels.max()) + 1, 1) if labels.size else 1)

    if masks is not None and len(masks):
        m = masks.astype(bool)
        # vectorized instance composite: last instance wins on overlap
        color_img = np.zeros_like(img)
        covered = np.zeros(img.shape[:2], bool)
        inst_cols = palette(len(m) + 7)[7:]  # offset: avoid label colors
        for i in range(len(m)):
            color_img[m[i]] = inst_cols[i]
            covered |= m[i]
        img[covered] = (img[covered] * 0.5 +
                        color_img[covered] * 0.5).astype(np.uint8)

    for box, lab in zip(bboxes, labels):
        c = tuple(int(x) for x in cols[int(lab)])
        x1, y1, x2, y2 = (int(round(v)) for v in box[:4])
        cv2.rectangle(img, (x1, y1), (x2, y2), c, thickness)
        txt = (class_names[int(lab)] if class_names is not None
               else f"cls {int(lab)}")
        if box.shape[-1] == 5:
            txt += f"|{box[4]:.02f}"
        cv2.putText(img, txt, (x1, max(y1 - 2, 0)),
                    cv2.FONT_HERSHEY_SIMPLEX, font_scale, c)
    if out_file is not None:
        cv2.imwrite(out_file, img[..., ::-1])
    return img


def show_result(
    img: np.ndarray,
    outputs: dict,
    class_names: Optional[Sequence[str]] = None,
    score_thr: float = 0.3,
    out_file: Optional[str] = None,
) -> np.ndarray:
    """BaseDetector.show_result equivalent over our fixed-capacity predict
    output dict (det_bboxes/det_scores/det_labels/num_keep + optional
    full-image det_masks)."""
    bboxes = np.asarray(outputs["det_bboxes"])
    if "det_scores" in outputs and bboxes.shape[-1] == 4:
        bboxes = np.concatenate(
            [bboxes, np.asarray(outputs["det_scores"])[:, None]], -1)
    return draw_detections(
        img, bboxes, np.asarray(outputs["det_labels"]),
        masks=np.asarray(outputs["det_masks"]) if "det_masks" in outputs
        else None,
        class_names=class_names, score_thr=score_thr,
        num_keep=int(outputs.get("num_keep", len(bboxes))),
        out_file=out_file)


def panoptic_to_color(pan: np.ndarray, divisor: int = 1000) -> np.ndarray:
    """Colorize an id-map (H,W int, category*divisor+instance) for quick
    inspection: hue from category, brightness jitter from instance id."""
    cat = (pan // divisor).astype(np.int64)
    inst = (pan % divisor).astype(np.int64)
    base = palette(int(cat.max()) + 1 if cat.size else 1)
    out = base[cat].astype(np.int16)
    out = out - (inst[..., None] * 23 % 64) + 32
    return np.clip(out, 0, 255).astype(np.uint8)
