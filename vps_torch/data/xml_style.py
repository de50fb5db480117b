"""Pascal-VOC-style XML datasets (the port's copy of the JAX package's
``data/xml_style.py``; mmdet's xml_style.py, voc.py, wider_face.py):
annotations parsed from each image's ``Annotations/<id>.xml``, the image
list from a plain-text split file. The sample contract is the COCO
datasets' (detection only: the masks are empty and the reference frame is
the image itself), so the port's TrainPipeline and TestPipeline, loader and
detectors take them unchanged. ``build_dataset`` finds them in
``vps_torch.data.dataset.DATASETS``.
"""

from __future__ import annotations

import os.path as osp
import xml.etree.ElementTree as ET
from typing import Optional

import numpy as np

from vps_torch.data.transforms import TestPipeline, TrainPipeline

try:
    import cv2
except ImportError:  # pragma: no cover
    cv2 = None


class XMLDataset:
    CLASSES: tuple = ()

    def __init__(
        self,
        ann_file: str,
        img_prefix: str,
        min_size: Optional[int] = None,
        test_mode: bool = False,
        pipeline=None,
        max_gt: int = 100,
        nframes_span_test: int = 1,
    ):
        self.img_prefix = img_prefix
        self.min_size = min_size
        self.test_mode = test_mode
        self.nframes_span_test = nframes_span_test
        self.cat2label = {c: i + 1 for i, c in enumerate(self.CLASSES)}
        with open(ann_file) as f:
            img_ids = [line.strip() for line in f if line.strip()]
        self.img_infos = []
        for img_id in img_ids:
            xml_path = osp.join(self.img_prefix, "Annotations",
                                f"{img_id}.xml")
            root = ET.parse(xml_path).getroot()
            size = root.find("size")
            self.img_infos.append(dict(
                id=img_id,
                filename=self._filename(root, img_id),
                width=int(size.find("width").text),
                height=int(size.find("height").text),
            ))
        if isinstance(pipeline, dict):
            cls = TestPipeline if test_mode else TrainPipeline
            pipeline = cls(**pipeline)
        if test_mode:
            self.pipeline = pipeline or TestPipeline()
        else:
            self.pipeline = pipeline or TrainPipeline(max_gt=max_gt)

    @staticmethod
    def _filename(root, img_id):
        return f"JPEGImages/{img_id}.jpg"

    def __len__(self):
        return len(self.img_infos)

    def get_ann_info(self, idx: int):
        """Difficult and under-``min_size`` boxes go to bboxes_ignore; the
        coordinates shift by -1 to the legacy 0-based frame."""
        img_id = self.img_infos[idx]["id"]
        xml_path = osp.join(self.img_prefix, "Annotations", f"{img_id}.xml")
        root = ET.parse(xml_path).getroot()
        bboxes, labels = [], []
        bboxes_ignore, labels_ignore = [], []
        for obj in root.findall("object"):
            name = obj.find("name").text
            if name not in self.cat2label:
                continue
            label = self.cat2label[name]
            diff = obj.find("difficult")
            difficult = int(diff.text) if diff is not None else 0
            bb = obj.find("bndbox")
            bbox = [int(float(bb.find(k).text))
                    for k in ("xmin", "ymin", "xmax", "ymax")]
            ignore = False
            if self.min_size:
                assert not self.test_mode
                if (bbox[2] - bbox[0] < self.min_size
                        or bbox[3] - bbox[1] < self.min_size):
                    ignore = True
            if difficult or ignore:
                bboxes_ignore.append(bbox)
                labels_ignore.append(label)
            else:
                bboxes.append(bbox)
                labels.append(label)
        to = lambda a, d: (np.asarray(a, np.float32).reshape(-1, 4) - 1
                           if d == 4 and len(a)
                           else (np.zeros((0, 4), np.float32) if d == 4
                                 else np.asarray(a, np.int64)))
        return dict(
            bboxes=to(bboxes, 4),
            labels=np.asarray(labels, np.int64),
            bboxes_ignore=to(bboxes_ignore, 4),
            labels_ignore=np.asarray(labels_ignore, np.int64),
        )

    def _load_img(self, filename):
        path = osp.join(self.img_prefix, filename)
        img = cv2.imread(path, cv2.IMREAD_COLOR)
        if img is None:
            raise FileNotFoundError(path)
        return img

    def prepare_train(self, idx: int, rng: np.random.RandomState):
        info = self.img_infos[idx]
        ann = self.get_ann_info(idx)
        if len(ann["bboxes"]) == 0:
            return None
        img = self._load_img(info["filename"])
        h, w = img.shape[:2]
        n = len(ann["bboxes"])
        sample = dict(
            img=img,
            ref_img=img,  # the image is its own reference frame
            gt_bboxes=ann["bboxes"],
            gt_labels=ann["labels"],
            gt_obj_ids=np.arange(n, dtype=np.int64),
            gt_masks=np.zeros((n, h, w), np.uint8),
            ref_bboxes=ann["bboxes"],
            ref_labels=ann["labels"],
            ref_obj_ids=np.arange(n, dtype=np.int64),
            ref_masks=np.zeros((n, h, w), np.uint8),
            gt_semantic_seg=np.full((h, w), 255, np.uint8),
        )
        return self.pipeline(sample, rng)

    def prepare_test(self, idx: int):
        info = self.img_infos[idx]
        img = self._load_img(info["filename"])
        pimg, pref, shape_nopad, factor = self.pipeline(img, img)
        meta = dict(
            filename=info["filename"],
            iid=info["id"],
            is_first=True,
            img_shape_withoutpad=shape_nopad,
            scale_factor=factor,
        )
        return pimg, pref, meta


class VOCDataset(XMLDataset):
    CLASSES = ("aeroplane", "bicycle", "bird", "boat", "bottle", "bus",
               "car", "cat", "chair", "cow", "diningtable", "dog", "horse",
               "motorbike", "person", "pottedplant", "sheep", "sofa",
               "train", "tvmonitor")

    def __init__(self, **kw):
        super().__init__(**kw)
        # the eval protocol differs between releases (mmdet's voc.py)
        if "VOC2007" in self.img_prefix:
            self.year = 2007
        elif "VOC2012" in self.img_prefix:
            self.year = 2012
        else:
            self.year = None


class WIDERFaceDataset(XMLDataset):
    """WIDER Face (mmdet's wider_face.py): one class, 'face'; the images
    live under per-event folders, named in each xml's <folder>."""

    CLASSES = ("face",)

    def _filename(self, root, img_id):
        folder = root.find("folder")
        fold = folder.text if folder is not None else ""
        return osp.join(fold, f"{img_id}.jpg")
