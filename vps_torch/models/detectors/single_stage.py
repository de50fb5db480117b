"""The single-stage detectors (port of vps_tpu/models/detectors/
single_stage.py): RetinaNet, RepPointsDetector, FCOS and SSD, and the
``SingleStageDetector`` type, which picks one of them by its head's type;
built from mmdetection v1 style config dicts.

Same contract as the R-CNN zoo (two_stage.py): ``predict`` takes one
normalised image (1, H, W, 3) NHWC and returns ``det_bboxes`` (max_per_img,
5) as (x1, y1, x2, y2, score) by score descending, 0-based ``det_labels``
and ``det_valid``, under ``inference_mode``, with the named
``torch.profiler`` ranges backbone_fpn, bbox_head and bbox_dets. ``loss``
takes one image and its gt padded to G boxes (``gt_valid``) and returns
JAX's loss dict (``loss_cls``, ``loss_bbox``; FCOS adds
``loss_centerness``; RepPoints has ``loss_cls``, ``loss_pts_init``,
``loss_pts_refine``), with the ranges backbone_fpn, bbox_head and
bbox_loss. No draw is random. Submodules carry mmdet's state_dict prefixes
(``backbone``, ``neck``, ``bbox_head``).

As in vps_tpu, RetinaNet's anchors are fixed (octave base 4, 3 scales an
octave, ratios 0.5, 1, 2 at strides 8-128) and it decodes with means 0 and
stds 1, whatever its head config says; FCOS and RepPoints assume the
strides 8-128, so the neck must give five levels from stride 8.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn as nn

from vps_torch import resolve_device
from vps_torch.core.assigner import max_iou_assign
from vps_torch.models.anchor_heads import (
    FCOSHead,
    RetinaHead,
    SSDHead,
    anchor_head_bboxes,
    fcos_bboxes,
    fcos_loss,
    ssd_anchor_generators,
    ssd_loss,
)
from vps_torch.models.reppoints import (
    RepPointsHead,
    reppoints_bboxes,
    reppoints_loss,
)
from vps_torch.models.ssd_vgg import SSDVGG  # noqa: F401  (registers it)
from vps_torch.ops.anchors import AnchorGenerator
from vps_torch.ops.box import bbox2delta
from vps_torch.ops.losses import sigmoid_focal_loss, smooth_l1_loss
from vps_torch.registry import BACKBONES, DETECTORS, NECKS, build_from_cfg

_stage = torch.profiler.record_function

STRIDES = (8, 16, 32, 64, 128)


def _channels_last(maps):
    """Per-level (1, C, H, W) -> one image's (H, W, C)."""
    return [m[0].permute(1, 2, 0) for m in maps]


class _SingleStage(nn.Module):
    """Backbone (+ neck) and a dense head; the subclasses say how the head
    is built (``_head``), decoded (``_decode``) and trained (``_loss``)."""

    def __init__(self, backbone: Dict[str, Any], bbox_head: Dict[str, Any],
                 neck: Optional[Dict[str, Any]] = None,
                 train_cfg: Optional[Dict[str, Any]] = None,
                 test_cfg: Optional[Dict[str, Any]] = None,
                 pretrained: Optional[str] = None, device="cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.device = dev
        self.train_cfg = train_cfg
        self.test_cfg = test_cfg
        self.backbone = build_from_cfg(backbone, BACKBONES, dict(device=dev))
        self.neck = (build_from_cfg(neck, NECKS, dict(device=dev)) if neck
                     else None)
        head = dict(bbox_head)
        head.pop("type", None)
        self.bbox_head = self._head(head, dev)
        self.eval()  # frozen BN

    def _head(self, cfg, dev):
        raise NotImplementedError

    def extract_feat(self, img):
        """img (1, H, W, 3) -> the levels, a tuple of (1, C, H_l, W_l)."""
        x = self.backbone(img.permute(0, 3, 1, 2))
        return self.neck(x) if self.neck is not None else x

    def _anchors(self, maps):
        """Each level's anchors for its map's size (``anchor_gens`` and
        ``anchor_strides`` set by the anchor-based heads' ``_head``)."""
        return [g.grid_anchors(tuple(m.shape[-2:]), s, device=self.device)
                for g, m, s in zip(self.anchor_gens, maps,
                                   self.anchor_strides)]

    def _test(self, key, default):
        return (self.test_cfg or {}).get(key, default)

    def _nms_args(self, score_thr=0.05, nms_thr=0.5, max_per_img=100):
        return dict(nms_pre=self._test("nms_pre", 1000),
                    score_thr=self._test("score_thr", score_thr),
                    nms_thr=self._test("nms_thr", nms_thr),
                    max_per_img=self._test("max_per_img", max_per_img),
                    nms_cfg=self._test("nms", None))

    def loss(self, img, gt_bboxes, gt_labels, gt_valid,
             generator: Optional[torch.Generator] = None):
        """Loss terms of one image (1, H, W, 3): gt_bboxes (G, 4), gt_labels
        (G,) 1-based, gt_valid (G,). ``generator`` is accepted for the zoo's
        signature; nothing here draws."""
        with _stage("backbone_fpn"):
            x = self.extract_feat(img)
        with _stage("bbox_head"):
            outs = self.bbox_head(x)
        with _stage("bbox_loss"):
            return self._loss(outs, gt_bboxes, gt_labels, gt_valid)

    @torch.inference_mode()
    def predict(self, img):
        h, w = img.shape[1:3]
        with _stage("backbone_fpn"):
            x = self.extract_feat(img)
        with _stage("bbox_head"):
            outs = self.bbox_head(x)
        with _stage("bbox_dets"):
            dets, labels, valid = self._decode(outs, (h, w))
        return {"det_bboxes": dets, "det_labels": labels, "det_valid": valid}


@DETECTORS.register
class RetinaNet(_SingleStage):
    """ResNet-FPN + RetinaHead, focal loss; anchors at base size = stride,
    octave scales 4 x 2^(i/3), ratios 0.5, 1, 2."""

    def _head(self, cfg, dev):
        self.anchor_strides = STRIDES
        self.anchor_gens = [
            AnchorGenerator(s, [4 * 2 ** (i / 3) for i in range(3)],
                            [0.5, 1.0, 2.0]) for s in STRIDES]
        return RetinaHead(**cfg, device=dev)

    def _loss(self, outs, gt_bboxes, gt_labels, gt_valid):
        cls_scores, bbox_preds = outs
        anchors = torch.cat(self._anchors(cls_scores))
        fg = self.bbox_head.num_classes - 1
        cls_flat = torch.cat([c.reshape(-1, fg)
                              for c in _channels_last(cls_scores)])
        reg_flat = torch.cat([r.reshape(-1, 4)
                              for r in _channels_last(bbox_preds)])
        tc = self.train_cfg or {}
        assign = max_iou_assign(anchors, gt_bboxes,
                                pos_iou_thr=tc.get("pos_iou_thr", 0.5),
                                neg_iou_thr=tc.get("neg_iou_thr", 0.4),
                                min_pos_iou=tc.get("min_pos_iou", 0.0),
                                gt_labels=gt_labels, gt_valid=gt_valid)
        pos = assign.assigned_gt_inds > 0
        neg = assign.assigned_gt_inds == 0
        labels = torch.where(pos, assign.labels,
                             torch.zeros_like(assign.labels))
        num_pos = pos.float().sum().clamp(min=1.0)
        loss_cls = sigmoid_focal_loss(cls_flat, labels,
                                      weight=(pos | neg).float(),
                                      avg_factor=num_pos)
        gt_idx = (assign.assigned_gt_inds - 1).clamp(0, gt_bboxes.shape[0] - 1)
        targets = bbox2delta(anchors, gt_bboxes[gt_idx])
        loss_bbox = smooth_l1_loss(reg_flat, targets, beta=0.11,
                                   weight=pos.float()[:, None],
                                   avg_factor=num_pos)
        return {"loss_cls": loss_cls, "loss_bbox": loss_bbox}

    def _decode(self, outs, img_shape):
        cls_scores, bbox_preds = outs
        return anchor_head_bboxes(
            _channels_last(cls_scores), _channels_last(bbox_preds),
            self._anchors(cls_scores), img_shape,
            num_classes=self.bbox_head.num_classes, **self._nms_args())


@DETECTORS.register
class RepPointsDetector(_SingleStage):
    """ResNet-FPN + RepPointsHead: point sets refined once, boxes by the
    head's transform."""

    def _head(self, cfg, dev):
        return RepPointsHead(**cfg, device=dev)

    @staticmethod
    def _nhwc(outs):
        return [[m.permute(0, 2, 3, 1) for m in maps] for maps in outs]

    def _loss(self, outs, gt_bboxes, gt_labels, gt_valid):
        cls_scores, p_init, p_ref = self._nhwc(outs)
        return reppoints_loss(self.bbox_head, cls_scores, p_init, p_ref,
                              gt_bboxes, gt_labels, gt_valid,
                              self.train_cfg or {})

    def _decode(self, outs, img_shape):
        cls_scores, _, p_ref = self._nhwc(outs)
        return reppoints_bboxes(self.bbox_head, cls_scores, p_ref, img_shape,
                                **self._nms_args())


@DETECTORS.register
class FCOS(_SingleStage):
    """ResNet-FPN + FCOSHead: anchor-free points, distances, centerness."""

    def _head(self, cfg, dev):
        return FCOSHead(**cfg, device=dev)

    def _loss(self, outs, gt_bboxes, gt_labels, gt_valid):
        cls_scores, bbox_preds, ctrs = (_channels_last(m) for m in outs)
        return fcos_loss(cls_scores, bbox_preds, ctrs, STRIDES, gt_bboxes,
                         gt_labels, gt_valid,
                         num_classes=self.bbox_head.num_classes)

    def _decode(self, outs, img_shape):
        cls_scores, bbox_preds, ctrs = (_channels_last(m) for m in outs)
        return fcos_bboxes(cls_scores, bbox_preds, ctrs, STRIDES, img_shape,
                           num_classes=self.bbox_head.num_classes,
                           **self._nms_args())


@DETECTORS.register
class SSD(_SingleStage):
    """SSDVGG (no neck) + SSDHead: the SSD anchor plan, a softmax over all
    classes, MultiBox loss with hard-negative mining. The head config's
    anchor plan keys are read here; its ``in_channels`` are the backbone's
    levels'."""

    def _head(self, cfg, dev):
        self.input_size = cfg.pop("input_size", 300)
        self.anchor_strides = list(cfg.pop("anchor_strides",
                                           (8, 16, 32, 64, 100, 300)))
        ratios = [list(r) for r in cfg.pop(
            "anchor_ratios", ([2], [2, 3], [2, 3], [2, 3], [2], [2]))]
        ratio_range = tuple(cfg.pop("basesize_ratio_range", (0.15, 0.9)))
        self.target_means = tuple(cfg.pop("target_means", (0.0,) * 4))
        self.target_stds = tuple(cfg.pop("target_stds", (0.1, 0.1, 0.2, 0.2)))
        cfg.pop("in_channels", None)
        cfg.setdefault("anchors_per_level",
                       tuple(len(r) * 2 + 2 for r in ratios))
        self.anchor_gens = ssd_anchor_generators(
            self.input_size, num_levels=len(self.anchor_strides),
            strides=self.anchor_strides, anchor_ratios=ratios,
            basesize_ratio_range=ratio_range)
        return SSDHead(**cfg, in_channels=self.backbone.out_channels,
                       device=dev)

    def _loss(self, outs, gt_bboxes, gt_labels, gt_valid):
        cls_scores, bbox_preds = outs
        tc = self.train_cfg or {}
        assigner = tc.get("assigner", {})
        return ssd_loss(_channels_last(cls_scores), _channels_last(bbox_preds),
                        self._anchors(cls_scores), gt_bboxes, gt_labels,
                        gt_valid, num_classes=self.bbox_head.num_classes,
                        neg_pos_ratio=tc.get("neg_pos_ratio", 3),
                        smoothl1_beta=tc.get("smoothl1_beta", 1.0),
                        pos_iou_thr=assigner.get("pos_iou_thr", 0.5),
                        neg_iou_thr=assigner.get("neg_iou_thr", 0.5),
                        target_means=self.target_means,
                        target_stds=self.target_stds)

    def _decode(self, outs, img_shape):
        cls_scores, bbox_preds = outs
        return anchor_head_bboxes(
            _channels_last(cls_scores), _channels_last(bbox_preds),
            self._anchors(cls_scores), img_shape,
            num_classes=self.bbox_head.num_classes, use_sigmoid=False,
            target_means=self.target_means, target_stds=self.target_stds,
            **self._nms_args(score_thr=0.02, nms_thr=0.45, max_per_img=200))


_BY_HEAD = {"RetinaHead": RetinaNet, "SSDHead": SSD, "FCOSHead": FCOS,
            "RepPointsHead": RepPointsDetector}


def single_stage_detector(**cfg):
    """The ``SingleStageDetector`` type: the head's type (RetinaHead by
    default) picks the detector class."""
    head_type = (cfg.get("bbox_head") or {}).get("type", "RetinaHead")
    return _BY_HEAD[head_type](**cfg)


DETECTORS.register(single_stage_detector, name="SingleStageDetector")
