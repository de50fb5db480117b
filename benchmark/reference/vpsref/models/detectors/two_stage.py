"""Mask R-CNN (port of vps_tpu/models/detectors/two_stage.py's FasterRCNN
and MaskRCNN, inference), built from mmdetection v1 style config dicts.

Same contract as the JAX detector: ``predict`` takes one normalised image
(1, H, W, 3) NHWC and returns fixed capacities with validity masks:
``det_bboxes`` (max_per_img, 5) as (x1, y1, x2, y2, score) by score
descending, 0-based ``det_labels``, ``det_valid``, and ``mask_logits``
(max_per_img, 28, 28) of each detection's class (paste them with
``reference.vpsref.ops.mask.paste_masks``). It runs under ``no_grad``, with
named ``torch.profiler`` ranges for its stages: backbone_fpn (holding
backbone and neck), rpn, bbox_dets, mask. Submodules carry mmdet's
state_dict prefixes (``backbone``, ``neck``, ``rpn_head``, ``bbox_head``,
``mask_head``).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn as nn

from reference.vpsref import resolve_device
from reference.vpsref.models.bbox_head import get_det_bboxes
from reference.vpsref.models.mask_head import select_mask_channel
from reference.vpsref.models.rpn_head import RPNHead, rpn_proposals
from reference.vpsref.ops.anchors import AnchorGenerator
from reference.vpsref.ops.roi_align import multilevel_roi_align
from reference.vpsref.registry import (
    BACKBONES,
    DETECTORS,
    HEADS,
    NECKS,
    build_from_cfg,
)

# named ranges of predict's stages, read by torch.profiler
_stage = torch.profiler.record_function


def _build(cfg, registry, default_type=None, **default_args):
    return build_from_cfg(cfg, registry, default_args, default_type)


@DETECTORS.register
class MaskRCNN(nn.Module):
    """Backbone, neck, RPN head, RoIAlign, SharedFCBBoxHead and
    FCNMaskHead."""

    def __init__(self, backbone: Dict[str, Any],
                 rpn_head: Dict[str, Any],
                 bbox_roi_extractor: Dict[str, Any],
                 bbox_head: Dict[str, Any],
                 neck: Dict[str, Any],
                 mask_roi_extractor: Dict[str, Any],
                 mask_head: Dict[str, Any],
                 train_cfg: Optional[Dict[str, Any]] = None,
                 test_cfg: Optional[Dict[str, Any]] = None,
                 pretrained: Optional[str] = None, device="cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.train_cfg, self.test_cfg, self.device = train_cfg, test_cfg, dev
        self.backbone = _build(backbone, BACKBONES, device=dev)
        self.neck = _build(neck, NECKS, device=dev)
        r = dict(rpn_head)
        self.anchor_scales = list(r.get("anchor_scales", [8]))
        self.anchor_ratios = list(r.get("anchor_ratios", [0.5, 1.0, 2.0]))
        self.anchor_strides = list(r.get("anchor_strides", [4, 8, 16, 32, 64]))
        self.rpn_head = RPNHead(
            r.get("in_channels", 256), r.get("feat_channels", 256),
            len(self.anchor_scales) * len(self.anchor_ratios), device=dev)
        self.bbox_head = _build(bbox_head, HEADS, "SharedFCBBoxHead",
                                device=dev)
        self.mask_head = _build(mask_head, HEADS, "FCNMaskHead", device=dev)
        self.bbox_roi_cfg = dict(bbox_roi_extractor)
        self.mask_roi_cfg = dict(mask_roi_extractor)
        self.eval()  # frozen BN, no dropout

    def extract_feat(self, img):
        """img (1, H, W, 3) -> the pyramid, a tuple of (1, C, H_l, W_l), in
        the named ranges backbone and neck."""
        with _stage("backbone"):
            x = self.backbone(img.permute(0, 3, 1, 2))
        with _stage("neck"):
            return self.neck(x)

    def _anchors_for(self, cls_outs):
        return [AnchorGenerator(stride, self.anchor_scales, self.anchor_ratios)
                .grid_anchors(tuple(cls_outs[lvl].shape[-2:]), stride,
                              device=self.device)
                for lvl, stride in enumerate(self.anchor_strides)]

    def _test_proposals(self, x, img_shape):
        cls_outs, reg_outs = self.rpn_head(x)
        rcfg = self.test_cfg["rpn"]
        return rpn_proposals(
            [c[0].permute(1, 2, 0) for c in cls_outs],
            [r[0].permute(1, 2, 0) for r in reg_outs],
            self._anchors_for(cls_outs), img_shape,
            nms_pre=rcfg.get("nms_pre", 1000),
            nms_thr=rcfg.get("nms_thr", 0.7),
            max_num=rcfg.get("max_num", 1000))

    def _pool(self, feats, rois, cfg, default_size, valid=None):
        """RoIAlign of ``rois`` over the pyramid with an extractor config
        (out_size, sample_num, featmap_strides, sampling). Returns
        (R, S, S, C) NHWC."""
        strides = cfg.get("featmap_strides", [4, 8, 16, 32])
        layer = cfg.get("roi_layer", {})
        return multilevel_roi_align(
            [f[0].permute(1, 2, 0) for f in feats[:len(strides)]], rois,
            strides, layer.get("out_size", default_size),
            layer.get("sample_num", 2), valid=valid,
            sampling=layer.get("sampling", "bilinear"))

    # -- inference ---------------------------------------------------------

    @torch.no_grad()
    def predict(self, img):
        """Single-image inference."""
        tcfg = self.test_cfg or {}
        h, w = img.shape[1:3]
        with _stage("backbone_fpn"):
            x = self.extract_feat(img)
        with _stage("rpn"):
            proposals, _, proposal_valid = self._test_proposals(x, (h, w))
        with _stage("bbox_dets"):
            cls_score, bbox_pred = self.bbox_head(self._pool(
                x, proposals, self.bbox_roi_cfg, 7, proposal_valid))
            rcnn = tcfg.get("rcnn", {})
            dets, labels, valid = get_det_bboxes(
                proposals, cls_score, bbox_pred, (h, w),
                score_thr=rcnn.get("score_thr", 0.05),
                nms_iou_thr=rcnn.get("nms", {}).get("iou_thr", 0.5),
                max_per_img=rcnn.get("max_per_img", 100),
                target_means=self.bbox_head.target_means,
                target_stds=self.bbox_head.target_stds,
                valid=proposal_valid.float(), nms_cfg=rcnn.get("nms"))
        out = {"det_bboxes": dets, "det_labels": labels, "det_valid": valid}
        with _stage("mask"):
            mask_pred = self.mask_head(self._pool(
                x, dets[:, :4], self.mask_roi_cfg, 14, valid))
            out["mask_logits"] = select_mask_channel(mask_pred, labels + 1)
        return out
