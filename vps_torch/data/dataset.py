"""The video datasets (the port's copy of the JAX package's
``data/dataset.py``): Cityscapes-VPS and VIPER; the image-level Coco and
Cityscapes datasets are not ported. COCO-style json with per-instance
``inst_id``; training pairs each frame with a random reference frame at one
of ``offsets`` ids away (+-1 id is +-5 real frames in Cityscapes-VPS); test
enumerates all frames with ref = previous frame, resetting every
``nframes_span_test``. ``build_dataset`` dispatches on ``type`` through
``DATASETS``.
"""

from __future__ import annotations

import os
import os.path as osp
from typing import Any, Dict, List, Optional

import numpy as np

from vps_torch.data.coco import CocoIndex, ann_to_mask
from vps_torch.data.transforms import (
    MultiScaleFlipAug,
    TestPipeline,
    TrainPipeline,
)

try:
    import cv2
except ImportError:  # pragma: no cover
    cv2 = None

CLASSES = (
    "person", "rider", "car", "truck", "bus", "train", "motorcycle", "bicycle",
)


class CityscapesVPSDataset:
    CLASSES = CLASSES

    def __init__(
        self,
        ann_file: str,
        img_prefix: str,
        seg_prefix: Optional[str] = None,
        ref_prefix: Optional[str] = None,
        ref_ann_file: Optional[str] = None,
        offsets=(-1, 1),
        nframes_span_test: int = 30,
        test_mode: bool = False,
        pipeline=None,
        max_gt: int = 100,
        semantic2label: Optional[Dict[int, int]] = None,
    ):
        self.coco = CocoIndex(ann_file)
        self.img_prefix = img_prefix
        self.seg_prefix = seg_prefix
        self.ref_prefix = ref_prefix or img_prefix
        self.test_mode = test_mode
        self.offsets = list(offsets or [])
        self.nframes_span_test = nframes_span_test
        self.img_infos = [self.coco.load_img(i) for i in self.coco.img_ids]
        for info in self.img_infos:
            info["filename"] = info["file_name"]
        self.cat2label = {c: i + 1 for i, c in enumerate(self.coco.cat_ids)}
        if type(self).CLASSES is None:
            # VIPER: the class names are the json's categories, in cat_id
            # order (= label order)
            self.CLASSES = tuple(
                self.coco.cats[c]["name"] for c in self.coco.cat_ids
            )
        if ref_ann_file is not None and ref_ann_file != ann_file:
            self.ref_coco = CocoIndex(ref_ann_file)
        else:
            self.ref_coco = self.coco
        self.ref_img_ids = set(self.ref_coco.img_ids)
        self.iid2info = {info["id"]: info for info in self.img_infos}
        self.semantic2label = semantic2label
        if isinstance(pipeline, dict):
            # config-file form: pipeline=dict(img_scale=..., crop_size=...)
            # mirrors the reference configs' per-dataset pipeline settings
            cls = TestPipeline if test_mode else TrainPipeline
            pipeline = cls(**pipeline)
        if test_mode:
            self.pipeline = pipeline or TestPipeline()
        else:
            self.pipeline = pipeline or TrainPipeline(max_gt=max_gt)

    def __len__(self):
        return len(self.img_infos)

    # -- annotations --------------------------------------------------

    def _parse_anns(self, coco: CocoIndex, img_info) -> Dict[str, Any]:
        """cityscapes_vps.py:152-206: xywh→legacy xyxy (+w-1), skip crowd and
        degenerate boxes, collect inst ids + masks."""
        h, w = img_info["height"], img_info["width"]
        bboxes, labels, obj_ids, masks = [], [], [], []
        for ann in coco.load_anns(img_info["id"]):
            if ann.get("ignore", False) or ann.get("iscrowd", False):
                continue
            x1, y1, bw, bh = ann["bbox"]
            if ann.get("area", bw * bh) <= 0 or bw < 1 or bh < 1:
                continue
            bboxes.append([x1, y1, x1 + bw - 1, y1 + bh - 1])
            labels.append(self.cat2label[ann["category_id"]])
            if "inst_id" in ann:
                obj_ids.append(ann["inst_id"])
            else:
                # positional fallback carries NO cross-frame identity — the
                # track head would train on garbage correspondences. Warn
                # loudly once so a malformed VPS json can't pass silently.
                if not getattr(self, "_warned_no_inst_id", False):
                    import logging

                    logging.getLogger("vps_torch").warning(
                        "%s: annotation for image %s has no 'inst_id'; "
                        "falling back to per-frame positional ids (NOT valid "
                        "cross-frame track identities)",
                        type(self).__name__, img_info["id"],
                    )
                    self._warned_no_inst_id = True
                obj_ids.append(len(obj_ids))
            masks.append(ann_to_mask(ann["segmentation"], h, w))
        if bboxes:
            return dict(
                bboxes=np.asarray(bboxes, np.float32),
                labels=np.asarray(labels, np.int64),
                obj_ids=np.asarray(obj_ids, np.int64),
                masks=np.stack(masks),
            )
        return dict(
            bboxes=np.zeros((0, 4), np.float32),
            labels=np.zeros((0,), np.int64),
            obj_ids=np.zeros((0,), np.int64),
            masks=np.zeros((0, h, w), np.uint8),
        )

    def get_ann_info(self, idx: int) -> Dict[str, Any]:
        """Public per-image annotation accessor (CustomDataset.get_ann_info
        semantics) for evaluation tools: bboxes (N, 4) legacy xyxy, 1-based
        labels, obj ids, masks."""
        ann = self._parse_anns(self.coco, self.img_infos[idx])
        return dict(ann, bboxes_ignore=np.zeros((0, 4), np.float32))

    def _load_img(self, prefix, filename):
        path = osp.join(prefix, filename)
        img = cv2.imread(path, cv2.IMREAD_COLOR)
        if img is None:
            raise FileNotFoundError(path)
        return img

    def _load_seg(self, img_info):
        """Load the labelmap png for the target frame (semantic classes
        0..18; remapped via semantic2label when provided). Datasets without
        semantic labels (plain detection: seg_prefix=None) get an all-void
        map so the semantic CE contributes zero loss."""
        if self.seg_prefix is None:
            return np.full(
                (img_info["height"], img_info["width"]), 255, np.uint8
            )
        name = img_info["filename"].replace("jpg", "png")
        name = name.replace("leftImg8bit", "gtFine_color").replace(
            "newImg8bit", "final_mask"
        )
        path = osp.join(self.seg_prefix, name)
        seg = cv2.imread(path, cv2.IMREAD_UNCHANGED)
        if seg is None:
            raise FileNotFoundError(path)
        if seg.ndim == 3:
            seg = seg[..., 0]
        if self.semantic2label:
            out = seg.copy()
            for k, v in self.semantic2label.items():
                out[seg == k] = v
            seg = out
        return seg

    # -- train / test samples -----------------------------------------

    def prepare_train(self, idx: int, rng: np.random.RandomState):
        img_info = self.img_infos[idx]
        iid = img_info["id"]
        offsets = [m for m in self.offsets if iid + m in self.ref_img_ids]
        if not offsets:
            return None
        m = offsets[rng.randint(len(offsets))]
        ref_info = self.iid2info.get(iid + m) or self.ref_coco.load_img(iid + m)
        ref_info.setdefault("filename", ref_info["file_name"])

        ann = self._parse_anns(self.coco, img_info)
        ref_ann = self._parse_anns(self.ref_coco, ref_info)
        if len(ann["bboxes"]) == 0 or len(ref_ann["bboxes"]) == 0:
            return None
        sample = dict(
            img=self._load_img(self.img_prefix, img_info["filename"]),
            ref_img=self._load_img(self.ref_prefix, ref_info["filename"]),
            gt_bboxes=ann["bboxes"],
            gt_labels=ann["labels"],
            gt_obj_ids=ann["obj_ids"],
            gt_masks=ann["masks"],
            ref_bboxes=ref_ann["bboxes"],
            ref_labels=ref_ann["labels"],
            ref_obj_ids=ref_ann["obj_ids"],
            ref_masks=ref_ann["masks"],
            gt_semantic_seg=self._load_seg(img_info),
        )
        return self.pipeline(sample, rng)

    def _test_frames(self, idx: int):
        """Frame ``idx`` and its reference (the previous frame except at
        video-span starts, cityscapes_vps.py:137-148), as loaded, and the
        meta fields they share."""
        img_info = self.img_infos[idx]
        if idx % self.nframes_span_test > 0:
            ref_info = self.img_infos[idx - 1]
        else:
            ref_info = img_info
        img = self._load_img(self.img_prefix, img_info["filename"])
        ref_img = self._load_img(self.ref_prefix, ref_info["file_name"])
        meta = dict(filename=img_info["filename"], iid=img_info["id"],
                    is_first=(idx % self.nframes_span_test == 0))
        return img, ref_img, meta

    def prepare_test(self, idx: int):
        """Returns (img, ref_img, meta)."""
        img, ref_img, meta = self._test_frames(idx)
        pimg, pref, shape_nopad, factor = self.pipeline(img, ref_img)
        meta.update(img_shape_withoutpad=shape_nopad, scale_factor=factor)
        return pimg, pref, meta

    def prepare_test_aug(self, idx: int, flip: bool = True, scales=None):
        """Test-time augmentation variants of frame ``idx``, enumerated by
        MultiScaleFlipAug over ``scales`` (default: the test pipeline's
        scale) and, with ``flip``, each flipped. Returns (variants, meta):
        variant 0 is the plain test-pipeline output; meta as prepare_test's,
        of variant 0."""
        img, ref_img, meta = self._test_frames(idx)
        p = self.pipeline
        variants = MultiScaleFlipAug(
            img_scales=scales or (p.img_scale,), flip=flip,
            size_divisor=p.size_divisor, mean=p.mean, std=p.std)(img, ref_img)
        meta.update(img_shape_withoutpad=variants[0]["img_shape_withoutpad"],
                    scale_factor=variants[0]["scale_factor"])
        return variants, meta


class ViperDataset(CityscapesVPSDataset):
    """VIPER (day split): the same COCO-video machinery; the class names
    come from the json's categories (10 things; 23 semantic classes)."""

    CLASSES = None  # from the json's categories


# build_dataset's types; mmdet's image-level CocoDataset and
# CityscapesDataset are not ported
DATASETS = {cls.__name__: cls for cls in (CityscapesVPSDataset, ViperDataset)}
UNPORTED = ("CocoDataset", "CityscapesDataset")


class ConcatDataset:
    """Concatenation wrapper (mmdet's ConcatDataset): the index space is
    the concatenation of the parts."""

    def __init__(self, datasets):
        self.datasets = list(datasets)
        self.CLASSES = getattr(self.datasets[0], "CLASSES", None)
        self._offsets = np.cumsum([0] + [len(d) for d in self.datasets])

    def __len__(self):
        return int(self._offsets[-1])

    def _locate(self, idx):
        di = int(np.searchsorted(self._offsets, idx, side="right") - 1)
        return self.datasets[di], idx - int(self._offsets[di])

    def prepare_train(self, idx, rng):
        ds, i = self._locate(idx)
        return ds.prepare_train(i, rng)

    def prepare_test(self, idx):
        ds, i = self._locate(idx)
        return ds.prepare_test(i)

    def get_ann_info(self, idx):
        ds, i = self._locate(idx)
        return ds.get_ann_info(i)


def build_dataset(cfg: Dict[str, Any]):
    cfg = dict(cfg)
    t = cfg.pop("type", "CityscapesVPSDataset")
    if t == "RepeatDataset":
        times = cfg.get("times", 1)
        ds = build_dataset(cfg["dataset"])
        ds.repeat_times = times
        return ds
    if t == "ConcatDataset":
        return ConcatDataset([build_dataset(c) for c in cfg["datasets"]])
    # pipeline: a constructed Train/TestPipeline object or a kwargs dict
    # passes through; mm-style list-of-dict configs are not supported (the
    # fixed Train/TestPipeline replaces them)
    if not (callable(cfg.get("pipeline")) or isinstance(cfg.get("pipeline"), dict)):
        cfg.pop("pipeline", None)
    if t not in DATASETS:
        raise ValueError(
            f"dataset type {t!r} is not ported" if t in UNPORTED else
            f"unknown dataset type {t!r}; the port has {sorted(DATASETS)}")
    return DATASETS[t](**cfg)
