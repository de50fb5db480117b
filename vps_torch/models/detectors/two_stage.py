"""The two-stage R-CNN detectors (port of
vps_tpu/models/detectors/two_stage.py, inference): FasterRCNN, MaskRCNN,
FastRCNN (precomputed proposals), RPN (proposals only), DoubleHeadRCNN,
MaskScoringRCNN and GridRCNN, built from mmdetection v1 style config dicts.

Same contract as the JAX detectors: ``predict`` takes one normalised image
(1, H, W, 3) NHWC and returns fixed capacities with validity masks:
``det_bboxes`` (max_per_img, 5) as (x1, y1, x2, y2, score) by score
descending, 0-based ``det_labels``, ``det_valid``, and with a mask head
``mask_logits`` (max_per_img, 28, 28) of each detection's class (paste them
with ``vps_torch.ops.mask.paste_masks``); RPN returns ``proposals``,
``scores``, ``proposal_valid``. It runs under ``inference_mode``, with named
``torch.profiler`` ranges for its stages: backbone_fpn, rpn, bbox_dets,
mask (and grid for GridRCNN). Submodules carry mmdet's state_dict prefixes
(``backbone``, ``neck``, ``shared_head``, ``rpn_head``, ``bbox_head``,
``mask_head``, ``mask_iou_head``, ``grid_head``).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn as nn

from vps_torch import resolve_device
from vps_torch.models.bbox_head import get_det_bboxes
from vps_torch.models.mask_head import select_mask_channel
from vps_torch.models.mask_heads import grid_bboxes
from vps_torch.models.rpn_head import RPNHead, rpn_proposals
from vps_torch.ops.anchors import AnchorGenerator
from vps_torch.ops.roi_align import multilevel_roi_align
from vps_torch.registry import (
    BACKBONES,
    DETECTORS,
    HEADS,
    NECKS,
    SHARED_HEADS,
    build_from_cfg,
)

# named ranges of predict's stages, read by torch.profiler
_stage = torch.profiler.record_function


def _build(cfg, registry, default_type=None, **default_args):
    return build_from_cfg(cfg, registry, default_args, default_type)


def _single(cfg) -> bool:
    """A config for one module, not a per-stage list."""
    return cfg is not None and not isinstance(cfg, (list, tuple))


def roi_rescale(rois, scale_factor: float):
    """Scale RoI widths and heights about their centres (the +1
    convention)."""
    cx = (rois[:, 0] + rois[:, 2]) * 0.5
    cy = (rois[:, 1] + rois[:, 3]) * 0.5
    w = (rois[:, 2] - rois[:, 0] + 1.0) * scale_factor
    h = (rois[:, 3] - rois[:, 1] + 1.0) * scale_factor
    return torch.stack([cx - w * 0.5 + 0.5, cy - h * 0.5 + 0.5,
                        cx + w * 0.5 - 0.5, cy + h * 0.5 - 0.5], -1)


class _Trunk(nn.Module):
    """Backbone (+ neck) and the RPN head, shared by RPN and the R-CNNs."""

    def _setup_trunk(self, backbone, neck, rpn_head, test_cfg, dev):
        self.test_cfg = test_cfg
        self.device = dev
        self.backbone = _build(backbone, BACKBONES, device=dev)
        self.neck = _build(neck, NECKS, device=dev) if neck else None
        self.rpn_head = None
        if rpn_head is not None:
            r = dict(rpn_head)
            self.anchor_scales = list(r.get("anchor_scales", [8]))
            self.anchor_ratios = list(r.get("anchor_ratios", [0.5, 1.0, 2.0]))
            self.anchor_strides = list(r.get("anchor_strides",
                                             [4, 8, 16, 32, 64]))
            self.rpn_head = RPNHead(
                r.get("in_channels", 256), r.get("feat_channels", 256),
                len(self.anchor_scales) * len(self.anchor_ratios), device=dev)

    def extract_feat(self, img):
        """img (1, H, W, 3) -> the pyramid, a tuple of (1, C, H_l, W_l)."""
        x = self.backbone(img.permute(0, 3, 1, 2))
        return self.neck(x) if self.neck is not None else x

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


@DETECTORS.register
class FasterRCNN(_Trunk):
    """RPN + RoIAlign + SharedFCBBoxHead, and the base of the two-stage
    family: a ``mask_head`` adds the mask branch, the variants override the
    hooks (``_bbox_forward``, ``_extra_predict_mask``, ``_extra_predict``),
    the cascades the heads (``_setup_heads``)."""

    def __init__(self, backbone: Dict[str, Any],
                 rpn_head: Optional[Dict[str, Any]] = None,
                 bbox_roi_extractor: Optional[Dict[str, Any]] = None,
                 bbox_head: Optional[Dict[str, Any]] = None,
                 neck: Optional[Dict[str, Any]] = None,
                 shared_head: Optional[Dict[str, Any]] = None,
                 mask_roi_extractor: Optional[Dict[str, Any]] = None,
                 mask_head: Optional[Dict[str, Any]] = None,
                 train_cfg: Optional[Dict[str, Any]] = None,
                 test_cfg: Optional[Dict[str, Any]] = None,
                 pretrained: Optional[str] = None, device="cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.train_cfg = train_cfg
        self._setup_trunk(backbone, neck, rpn_head, test_cfg, dev)
        self.shared_head = (_build(shared_head, SHARED_HEADS, "ResLayer",
                                   device=dev) if shared_head else None)
        self._setup_heads(dict(bbox_roi_extractor=bbox_roi_extractor,
                               bbox_head=bbox_head,
                               mask_roi_extractor=mask_roi_extractor,
                               mask_head=mask_head), dev)
        self.eval()  # frozen BN, no dropout

    def _setup_heads(self, cfgs, dev):
        """The box and mask heads and their RoI extractor settings."""
        self.bbox_head = (_build(cfgs["bbox_head"], HEADS, "SharedFCBBoxHead",
                                 device=dev)
                          if _single(cfgs["bbox_head"]) else None)
        self.mask_head = (_build(cfgs["mask_head"], HEADS, "FCNMaskHead",
                                 device=dev)
                          if _single(cfgs["mask_head"]) else None)
        bbox_roi = cfgs["bbox_roi_extractor"]
        mask_roi = cfgs["mask_roi_extractor"]
        self.bbox_roi_cfg = dict(bbox_roi) if _single(bbox_roi) else {}
        self.mask_roi_cfg = (dict(mask_roi) if _single(mask_roi)
                             else self.bbox_roi_cfg)

    # -- shared pieces ---------------------------------------------------

    def _pool(self, feats, rois, cfg, default_size, valid=None,
              roi_scale_factor=None, shared: bool = True):
        """RoIAlign of ``rois`` over the pyramid with an extractor config
        (out_size, sample_num, featmap_strides, sampling), then the shared
        head when there is one. Returns (R, S, S, C) NHWC."""
        strides = cfg.get("featmap_strides", [4, 8, 16, 32])
        layer = cfg.get("roi_layer", {})
        if roi_scale_factor is not None:
            rois = roi_rescale(rois, roi_scale_factor)
        out = multilevel_roi_align(
            [f[0].permute(1, 2, 0) for f in feats[:len(strides)]], rois,
            strides, layer.get("out_size", default_size),
            layer.get("sample_num", 2), valid=valid,
            sampling=layer.get("sampling", "bilinear"))
        if self.shared_head is not None and shared:
            out = self.shared_head(out)
        return out

    def _roi_feats(self, feats, rois, which: str, valid=None,
                   roi_scale_factor=None):
        if which == "bbox":
            return self._pool(feats, rois, self.bbox_roi_cfg, 7, valid,
                              roi_scale_factor)
        return self._pool(feats, rois, self.mask_roi_cfg, 14, valid,
                          roi_scale_factor)

    def _bbox_forward(self, x, rois, valid):
        """Hook: RoI features -> (cls logits, deltas), and the features."""
        feats = self._roi_feats(x, rois, "bbox", valid=valid)
        return self.bbox_head(feats), feats

    # -- inference ---------------------------------------------------------

    @torch.inference_mode()
    def predict(self, img, proposals=None, proposal_valid=None):
        """Single-image inference; ``proposals`` (P, 4) and
        ``proposal_valid`` (P,) only for a detector without an RPN head."""
        tcfg = self.test_cfg or {}
        h, w = img.shape[1:3]
        with _stage("backbone_fpn"):
            x = self.extract_feat(img)
        if self.rpn_head is not None:
            with _stage("rpn"):
                proposals, _, proposal_valid = self._test_proposals(x, (h, w))
        if proposals is None:
            raise ValueError(f"{type(self).__name__} has no RPN head: "
                             f"predict needs proposals")
        with _stage("bbox_dets"):
            (cls_score, bbox_pred), _ = self._bbox_forward(
                x, proposals, proposal_valid)
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
        if self.mask_head is not None:
            with _stage("mask"):
                mask_feats = self._roi_feats(x, dets[:, :4], "mask",
                                             valid=valid)
                mask_pred = self.mask_head(mask_feats)
                out["mask_logits"] = select_mask_channel(mask_pred, labels + 1)
                self._extra_predict_mask(out, mask_feats, mask_pred)
        self._extra_predict(out, x, (h, w))
        return out

    def _extra_predict_mask(self, out, mask_feats, mask_pred):
        """Hook after the mask prediction (MaskScoringRCNN)."""

    def _extra_predict(self, out, x, img_shape):
        """Hook after detection (GridRCNN's refinement)."""


@DETECTORS.register
class MaskRCNN(FasterRCNN):
    """FasterRCNN + FCNMaskHead: the config supplies mask_roi_extractor and
    mask_head; the class exists for ``type`` parity."""


@DETECTORS.register
class FastRCNN(FasterRCNN):
    """No RPN head: predict takes precomputed proposals."""


@DETECTORS.register
class RPN(_Trunk):
    """Proposals only: backbone (+ neck) + RPNHead."""

    def __init__(self, backbone: Dict[str, Any], rpn_head: Dict[str, Any],
                 neck: Optional[Dict[str, Any]] = None,
                 train_cfg: Optional[Dict[str, Any]] = None,
                 test_cfg: Optional[Dict[str, Any]] = None,
                 pretrained: Optional[str] = None, device="cuda"):
        super().__init__()
        self.train_cfg = train_cfg
        self._setup_trunk(backbone, neck, rpn_head, test_cfg,
                          resolve_device(device))
        self.eval()

    @torch.inference_mode()
    def predict(self, img):
        """-> proposals (max_num, 4), scores (max_num,), proposal_valid."""
        h, w = img.shape[1:3]
        with _stage("backbone_fpn"):
            x = self.extract_feat(img)
        with _stage("rpn"):
            proposals, scores, valid = self._test_proposals(x, (h, w))
        return {"proposals": proposals, "scores": scores,
                "proposal_valid": valid}


@DETECTORS.register
class DoubleHeadRCNN(FasterRCNN):
    """Double-Head R-CNN: the reg branch pools RoIs scaled by
    ``reg_roi_scale_factor``; both windows feed DoubleConvFCBBoxHead."""

    def __init__(self, *args, reg_roi_scale_factor: float = 1.3, **kwargs):
        self.reg_roi_scale_factor = reg_roi_scale_factor
        super().__init__(*args, **kwargs)

    def _bbox_forward(self, x, rois, valid):
        cls_feats = self._roi_feats(x, rois, "bbox", valid=valid)
        reg_feats = self._roi_feats(
            x, rois, "bbox", valid=valid,
            roi_scale_factor=self.reg_roi_scale_factor)
        return self.bbox_head(cls_feats, reg_feats), cls_feats


@DETECTORS.register
class MaskScoringRCNN(FasterRCNN):
    """Mask Scoring R-CNN: MaskRCNN + MaskIoUHead; predict adds
    ``mask_scores`` = box score x the predicted mask IoU of its class."""

    def __init__(self, *args, mask_iou_head: Optional[Dict[str, Any]] = None,
                 **kwargs):
        self._mask_iou_cfg = mask_iou_head
        super().__init__(*args, **kwargs)

    def _setup_heads(self, cfgs, dev):
        super()._setup_heads(cfgs, dev)
        self.mask_iou_head = _build(self._mask_iou_cfg or {}, HEADS,
                                    "MaskIoUHead", device=dev)

    def _extra_predict_mask(self, out, mask_feats, mask_pred):
        labels = out["det_labels"]
        iou_pred = self.mask_iou_head(mask_feats, out["mask_logits"])
        iou = iou_pred.gather(1, (labels + 1)[:, None])[:, 0]
        out["mask_scores"] = out["det_bboxes"][:, 4] * iou


@DETECTORS.register
class GridRCNN(FasterRCNN):
    """Grid R-CNN Plus: classification from the box head, localisation from
    grid-point heatmap voting over each detection's doubled window."""

    def __init__(self, *args, grid_roi_extractor: Optional[Dict[str, Any]] = None,
                 grid_head: Optional[Dict[str, Any]] = None, **kwargs):
        self._grid_cfgs = (grid_roi_extractor, grid_head)
        super().__init__(*args, **kwargs)

    def _setup_heads(self, cfgs, dev):
        super()._setup_heads(cfgs, dev)
        roi_cfg, head_cfg = self._grid_cfgs
        self.grid_head = _build(head_cfg or {}, HEADS, "GridHead", device=dev)
        self.grid_roi_cfg = dict(roi_cfg or self.bbox_roi_cfg)

    def _extra_predict(self, out, x, img_shape):
        with _stage("grid"):
            dets, valid = out["det_bboxes"], out["det_valid"]
            fused = self.grid_head(self._pool(x, dets[:, :4], self.grid_roi_cfg,
                                              14, valid, shared=False))
            refined = grid_bboxes(dets[:, :4], fused, img_shape,
                                  grid_points=self.grid_head.grid_points,
                                  roi_feat_size=self.grid_head.roi_feat_size)
            out["det_bboxes"] = torch.cat(
                [torch.where(valid[:, None], refined,
                             torch.zeros_like(refined)), dets[:, 4:]], -1)
