"""SSD's extra augmentations (port of vps_tpu/data/extra_aug.py: mmdet's
PhotoMetricDistortion, Expand and MinIoU RandomCrop, composed by
ExtraAugmentation): host-side numpy on one image and its boxes, applied
before a pipeline's resize. No pipeline of the port wires them in, as none
of vps_tpu's does.

Every draw comes from the ``np.random.RandomState`` a call is given, in
vps_tpu's order, so the outputs are bit for bit vps_tpu's. HSV is its own
numpy conversion (H in degrees [0, 360), S and V in the image's scale).
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def rgb_to_hsv(img):
    """(H, W, 3) float RGB (any max scale) → HSV with H in [0, 360)."""
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    mx = np.max(img, axis=-1)
    mn = np.min(img, axis=-1)
    diff = mx - mn
    safe = np.where(diff == 0, 1.0, diff)
    h = np.where(
        mx == r, (g - b) / safe % 6.0,
        np.where(mx == g, (b - r) / safe + 2.0, (r - g) / safe + 4.0),
    ) * 60.0
    h = np.where(diff == 0, 0.0, h)
    s = np.where(mx == 0, 0.0, diff / np.where(mx == 0, 1.0, mx))
    return np.stack([h, s, mx], axis=-1)


def hsv_to_rgb(hsv):
    h, s, v = hsv[..., 0] / 60.0, hsv[..., 1], hsv[..., 2]
    c = v * s
    x = c * (1.0 - np.abs(h % 2.0 - 1.0))
    m = v - c
    z = np.zeros_like(c)
    idx = np.floor(h).astype(np.int32) % 6
    rgb_options = np.stack([
        np.stack([c, x, z], -1), np.stack([x, c, z], -1),
        np.stack([z, c, x], -1), np.stack([z, x, c], -1),
        np.stack([x, z, c], -1), np.stack([c, z, x], -1),
    ], axis=0)
    rgb = np.take_along_axis(
        rgb_options, idx[None, ..., None], axis=0)[0]
    return rgb + m[..., None]


class PhotoMetricDistortion:
    """Random brightness / saturation / hue / contrast / channel swap
    (extra_aug.py:9-66; mode fixed to contrast-last as in the reference)."""

    def __init__(self, brightness_delta=32, contrast_range=(0.5, 1.5),
                 saturation_range=(0.5, 1.5), hue_delta=18):
        self.brightness_delta = brightness_delta
        self.contrast_lower, self.contrast_upper = contrast_range
        self.saturation_lower, self.saturation_upper = saturation_range
        self.hue_delta = hue_delta

    def __call__(self, img, boxes, labels, rng: np.random.RandomState):
        img = img.astype(np.float32)
        if rng.randint(2):
            img = img + rng.uniform(-self.brightness_delta,
                                    self.brightness_delta)
        hsv = rgb_to_hsv(img)
        if rng.randint(2):
            hsv[..., 1] *= rng.uniform(self.saturation_lower,
                                       self.saturation_upper)
        if rng.randint(2):
            hsv[..., 0] += rng.uniform(-self.hue_delta, self.hue_delta)
            hsv[..., 0] %= 360.0
        img = hsv_to_rgb(hsv)
        if rng.randint(2):
            img = img * rng.uniform(self.contrast_lower, self.contrast_upper)
        if rng.randint(2):
            img = img[..., rng.permutation(3)]
        return img, boxes, labels


class Expand:
    """Paste the image at a random offset on a mean-filled larger canvas
    (extra_aug.py:69-89)."""

    def __init__(self, mean=(0.0, 0.0, 0.0), ratio_range=(1, 4)):
        self.mean = np.asarray(mean, np.float32)
        self.min_ratio, self.max_ratio = ratio_range

    def __call__(self, img, boxes, labels, rng: np.random.RandomState):
        if rng.randint(2):
            return img, boxes, labels
        h, w, c = img.shape
        ratio = rng.uniform(self.min_ratio, self.max_ratio)
        canvas = np.empty((int(h * ratio), int(w * ratio), c), img.dtype)
        canvas[...] = self.mean
        left = int(rng.uniform(0, w * ratio - w))
        top = int(rng.uniform(0, h * ratio - h))
        canvas[top:top + h, left:left + w] = img
        boxes = boxes + np.tile((left, top), 2).astype(boxes.dtype)
        return canvas, boxes, labels


def _iou(patch, boxes):
    lt = np.maximum(patch[:2], boxes[:, :2])
    rb = np.minimum(patch[2:], boxes[:, 2:])
    inter = np.prod(np.clip(rb - lt, 0, None), axis=1)
    a1 = np.prod(patch[2:] - patch[:2])
    a2 = np.prod(boxes[:, 2:] - boxes[:, :2], axis=1)
    return inter / np.maximum(a1 + a2 - inter, 1e-9)


class MinIoURandomCrop:
    """Sample a crop whose IoU with every gt box exceeds a random threshold,
    keep boxes whose centers fall inside (extra_aug.py:92-141 RandomCrop)."""

    def __init__(self, min_ious=(0.1, 0.3, 0.5, 0.7, 0.9),
                 min_crop_size=0.3):
        self.sample_mode = (1, *min_ious, 0)
        self.min_crop_size = min_crop_size

    def __call__(self, img, boxes, labels, rng: np.random.RandomState):
        h, w = img.shape[:2]
        while True:
            mode = self.sample_mode[rng.randint(len(self.sample_mode))]
            if mode == 1:
                return img, boxes, labels
            min_iou = mode
            for _ in range(50):
                new_w = rng.uniform(self.min_crop_size * w, w)
                new_h = rng.uniform(self.min_crop_size * h, h)
                if new_h / new_w < 0.5 or new_h / new_w > 2:
                    continue
                left = rng.uniform(0, w - new_w)
                top = rng.uniform(0, h - new_h)
                patch = np.asarray(
                    [int(left), int(top), int(left + new_w),
                     int(top + new_h)])
                if boxes.shape[0] and _iou(patch, boxes).min() < min_iou:
                    continue
                center = (boxes[:, :2] + boxes[:, 2:]) / 2
                mask = ((center[:, 0] > patch[0]) & (center[:, 1] > patch[1])
                        & (center[:, 0] < patch[2])
                        & (center[:, 1] < patch[3]))
                if not mask.any():
                    continue
                boxes = boxes[mask].copy()
                labels = labels[mask]
                img = img[patch[1]:patch[3], patch[0]:patch[2]]
                boxes[:, 2:] = boxes[:, 2:].clip(max=patch[2:])
                boxes[:, :2] = boxes[:, :2].clip(min=patch[:2])
                boxes -= np.tile(patch[:2], 2)
                return img, boxes, labels


class ExtraAugmentation:
    """Config-driven composition (extra_aug.py:144-160)."""

    def __init__(self, photo_metric_distortion=None, expand=None,
                 random_crop=None):
        self.transforms = []
        if photo_metric_distortion is not None:
            self.transforms.append(
                PhotoMetricDistortion(**photo_metric_distortion))
        if expand is not None:
            self.transforms.append(Expand(**expand))
        if random_crop is not None:
            self.transforms.append(MinIoURandomCrop(**random_crop))

    def __call__(self, img, boxes, labels,
                 rng: Optional[np.random.RandomState] = None):
        rng = rng or np.random.RandomState()
        img = img.astype(np.float32)
        boxes = np.asarray(boxes, np.float32)
        for t in self.transforms:
            img, boxes, labels = t(img, boxes, labels, rng)
        return img, boxes, labels
