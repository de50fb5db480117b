"""Numpy data pipeline, on the host, emitting fixed-shape samples (the
port's copy of the JAX package's ``data/transforms.py``, the test-time
augmentation enumerator ``MultiScaleFlipAug`` included).

The reference train pipeline: keep-ratio resize with ratio jitter 0.8-1.5
of (2048, 1024), horizontal flip 0.5, BGR->RGB + normalize, random crop
800x1600 (reference fields in lockstep), pad to a multiple of 32, semantic
labels at x1 and x0.25; then static-shape formatting (gt sets padded to
``max_gt`` with validity masks, and the track pids derived). Samples are
NHWC float32 images and the keys ``PanopticFuseTrack.loss`` takes.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

try:
    import cv2
except ImportError:  # pragma: no cover
    cv2 = None

IMG_MEAN = np.array([123.675, 116.28, 103.53], np.float32)
IMG_STD = np.array([58.395, 57.12, 57.375], np.float32)


def imrescale(img, scale: Tuple[int, int], interp="bilinear"):
    """mmcv.imrescale: scale=(max_long, max_short); keep aspect ratio."""
    h, w = img.shape[:2]
    max_long, max_short = max(scale), min(scale)
    factor = min(max_long / max(h, w), max_short / min(h, w))
    new_w = int(w * factor + 0.5)
    new_h = int(h * factor + 0.5)
    flag = cv2.INTER_LINEAR if interp == "bilinear" else cv2.INTER_NEAREST
    out = cv2.resize(img, (new_w, new_h), interpolation=flag)
    return out, factor


class TrainPipeline:
    def __init__(
        self,
        img_scale=(2048, 1024),
        ratio_range=(0.8, 1.5),
        flip_ratio=0.5,
        crop_size=(800, 1600),
        size_divisor=32,
        seg_scales=(1.0, 0.25),
        max_gt=100,
        mean=IMG_MEAN,
        std=IMG_STD,
    ):
        self.img_scale = img_scale
        self.ratio_range = ratio_range
        self.flip_ratio = flip_ratio
        self.crop_size = crop_size
        self.size_divisor = size_divisor
        self.seg_scales = seg_scales
        self.max_gt = max_gt
        self.mean = mean
        self.std = std

    def __call__(self, sample: Dict, rng: np.random.RandomState) -> Optional[Dict]:
        """sample: img, ref_img (H, W, 3 BGR uint8); gt_bboxes (N, 4),
        gt_labels, gt_obj_ids, gt_masks (N, H, W); ref_* twins;
        gt_semantic_seg (H, W). Returns a fixed-shape dict or None if the
        crop leaves no gt (reference skips such samples)."""
        img = sample["img"]
        ref_img = sample["ref_img"]
        seg = sample["gt_semantic_seg"]

        # Resize with ratio jitter
        ratio = rng.uniform(*self.ratio_range)
        scale = (int(self.img_scale[0] * ratio), int(self.img_scale[1] * ratio))
        img, factor = imrescale(img, scale)
        ref_img, _ = imrescale(ref_img, scale)
        seg, _ = imrescale(seg, scale, interp="nearest")
        h, w = img.shape[:2]

        def scale_boxes(b):
            b = b * factor
            b[:, 0::2] = np.clip(b[:, 0::2], 0, w - 1)
            b[:, 1::2] = np.clip(b[:, 1::2], 0, h - 1)
            return b

        gt_bboxes = scale_boxes(sample["gt_bboxes"].copy())
        ref_bboxes = scale_boxes(sample["ref_bboxes"].copy())
        gt_masks = np.stack(
            [imrescale(m, scale, "nearest")[0] for m in sample["gt_masks"]]
        ) if len(sample["gt_masks"]) else np.zeros((0, h, w), np.uint8)
        ref_masks = np.stack(
            [imrescale(m, scale, "nearest")[0] for m in sample["ref_masks"]]
        ) if len(sample["ref_masks"]) else np.zeros((0, h, w), np.uint8)

        # Flip
        if rng.rand() < self.flip_ratio:
            img = img[:, ::-1]
            ref_img = ref_img[:, ::-1]
            seg = seg[:, ::-1]
            gt_masks = gt_masks[:, :, ::-1]
            ref_masks = ref_masks[:, :, ::-1]
            for b in (gt_bboxes, ref_bboxes):
                x1 = b[:, 0].copy()
                b[:, 0] = w - b[:, 2] - 1
                b[:, 2] = w - x1 - 1

        # Normalize (BGR→RGB then (x-mean)/std)
        img = (img[..., ::-1].astype(np.float32) - self.mean) / self.std
        ref_img = (ref_img[..., ::-1].astype(np.float32) - self.mean) / self.std

        # Random crop
        ch, cw = self.crop_size
        ch = min(ch, h)
        cw = min(cw, w)
        y0 = rng.randint(0, h - ch + 1)
        x0 = rng.randint(0, w - cw + 1)
        img = img[y0 : y0 + ch, x0 : x0 + cw]
        ref_img = ref_img[y0 : y0 + ch, x0 : x0 + cw]
        seg = seg[y0 : y0 + ch, x0 : x0 + cw]
        gt_masks = gt_masks[:, y0 : y0 + ch, x0 : x0 + cw]
        ref_masks = ref_masks[:, y0 : y0 + ch, x0 : x0 + cw]

        def crop_boxes(b, masks, labels, obj_ids):
            b = b.copy()
            b[:, 0::2] -= x0
            b[:, 1::2] -= y0
            b[:, 0::2] = np.clip(b[:, 0::2], 0, cw - 1)
            b[:, 1::2] = np.clip(b[:, 1::2], 0, ch - 1)
            keep = (b[:, 2] > b[:, 0]) & (b[:, 3] > b[:, 1])
            return b[keep], masks[keep], labels[keep], obj_ids[keep]

        gt_bboxes, gt_masks, gt_labels, gt_obj_ids = crop_boxes(
            gt_bboxes, gt_masks, sample["gt_labels"], sample["gt_obj_ids"]
        )
        ref_bboxes, ref_masks, ref_labels, ref_obj_ids = crop_boxes(
            ref_bboxes, ref_masks, sample["ref_labels"], sample["ref_obj_ids"]
        )
        if len(gt_bboxes) == 0 or len(ref_bboxes) == 0:
            return None

        # Pad to size divisor (cityscapes train crop is already ÷32)
        div = self.size_divisor
        ph = (-ch) % div
        pw = (-cw) % div
        if ph or pw:
            img = np.pad(img, ((0, ph), (0, pw), (0, 0)))
            ref_img = np.pad(ref_img, ((0, ph), (0, pw), (0, 0)))
            seg = np.pad(seg, ((0, ph), (0, pw)), constant_values=255)
            gt_masks = np.pad(gt_masks, ((0, 0), (0, ph), (0, pw)))
            ref_masks = np.pad(ref_masks, ((0, 0), (0, ph), (0, pw)))
        hh, ww = img.shape[:2]

        # semantic labels at the two scales (nearest)
        seg_full = seg.astype(np.int32)
        s = self.seg_scales[1]
        seg_nx = cv2.resize(
            seg.astype(np.uint8), (int(ww * s), int(hh * s)),
            interpolation=cv2.INTER_NEAREST,
        ).astype(np.int32)

        # tracking pids: cur obj id → 1 + index in ref objs, 0 if new
        ref_ids = ref_obj_ids.tolist()
        gt_pids = np.array(
            [ref_ids.index(i) + 1 if i in ref_ids else 0 for i in gt_obj_ids],
            np.int32,
        )

        return self._format(
            img, ref_img, gt_bboxes, gt_labels, gt_masks, gt_pids,
            ref_bboxes, seg_full, seg_nx,
        )

    def _format(self, img, ref_img, gt_bboxes, gt_labels, gt_masks, gt_pids,
                ref_bboxes, seg_full, seg_nx):
        m = self.max_gt
        n = min(len(gt_bboxes), m)
        r = min(len(ref_bboxes), m)
        hh, ww = img.shape[:2]

        gt_b = np.zeros((m, 4), np.float32)
        gt_b[:n] = gt_bboxes[:n]
        gt_l = np.zeros((m,), np.int32)
        gt_l[:n] = gt_labels[:n]
        gt_v = np.zeros((m,), bool)
        gt_v[:n] = True
        gt_m = np.zeros((m, hh, ww), np.float32)
        gt_m[:n] = gt_masks[:n]
        gt_p = np.zeros((m,), np.int32)
        gt_p[:n] = gt_pids[:n]
        ref_b = np.zeros((m, 4), np.float32)
        ref_b[:r] = ref_bboxes[:r]
        ref_v = np.zeros((m,), bool)
        ref_v[:r] = True
        return dict(
            img=img.astype(np.float32),
            ref_img=ref_img.astype(np.float32),
            gt_bboxes=gt_b,
            gt_labels=gt_l,
            gt_valid=gt_v,
            gt_masks=gt_m,
            gt_semantic_seg=seg_full,
            gt_semantic_seg_Nx=seg_nx,
            gt_pids=gt_p,
            ref_bboxes=ref_b,
            ref_valid=ref_v,
        )


class TestPipeline:
    """Eval-time: resize to (2048, 1024) keep-ratio, normalize, pad ÷32."""

    def __init__(self, img_scale=(2048, 1024), size_divisor=32,
                 mean=IMG_MEAN, std=IMG_STD):
        self.img_scale = img_scale
        self.size_divisor = size_divisor
        self.mean = mean
        self.std = std

    def __call__(self, img, ref_img):
        img, factor = imrescale(img, self.img_scale)
        ref_img, _ = imrescale(ref_img, self.img_scale)
        h, w = img.shape[:2]
        img = (img[..., ::-1].astype(np.float32) - self.mean) / self.std
        ref_img = (ref_img[..., ::-1].astype(np.float32) - self.mean) / self.std
        div = self.size_divisor
        ph = (-h) % div
        pw = (-w) % div
        if ph or pw:
            img = np.pad(img, ((0, ph), (0, pw), (0, 0)))
            ref_img = np.pad(ref_img, ((0, ph), (0, pw), (0, 0)))
        return img, ref_img, (h, w), factor


class MultiScaleFlipAug:
    """Test-time augmentation enumerator (mmdet's MultiScaleFlipAug): one
    TestPipeline output per (scale x flip) variant, with the meta a caller
    needs to invert the transforms when it merges the predictions. A flip
    acts within the valid content region [0, w), as mmdet resizes, flips,
    then pads: the content stays in the top-left corner, and boxes map with
    mmdet's convention (flip over the variant's img_shape)."""

    def __init__(self, img_scales=((2048, 1024),), flip=False,
                 size_divisor=32, mean=IMG_MEAN, std=IMG_STD):
        if isinstance(img_scales[0], int):
            img_scales = (img_scales,)
        self.img_scales = list(img_scales)
        self.flip_variants = [False, True] if flip else [False]
        self.size_divisor = size_divisor
        self.mean = mean
        self.std = std

    def __call__(self, img, ref_img):
        outs = []
        for scale in self.img_scales:
            pipe = TestPipeline(scale, self.size_divisor, self.mean, self.std)
            base_img, base_ref, shape, factor = pipe(img, ref_img)
            for flip in self.flip_variants:
                v_img, v_ref = base_img, base_ref
                if flip:
                    hv, wv = shape
                    v_img = base_img.copy()
                    v_ref = base_ref.copy()
                    v_img[:hv, :wv] = base_img[:hv, :wv][:, ::-1]
                    v_ref[:hv, :wv] = base_ref[:hv, :wv][:, ::-1]
                outs.append(dict(
                    img=v_img, ref_img=v_ref, img_shape_withoutpad=shape,
                    scale_factor=factor, flip=flip, scale=tuple(scale)))
        return outs
