"""The two-stage R-CNN detectors (port of
vps_tpu/models/detectors/two_stage.py): FasterRCNN, MaskRCNN, FastRCNN
(precomputed proposals), RPN (proposals only), DoubleHeadRCNN,
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

``loss`` takes one image with its gt padded to G boxes (``gt_valid``) and
returns JAX's loss dict: the RPN's anchor losses (``loss_rpn_cls``,
``loss_rpn_bbox``), then on the sampled RoIs of the detached proposals
``loss_cls``, ``acc``, ``loss_bbox`` and with a mask head ``loss_mask``
(Mask Scoring adds ``loss_mask_iou``, Grid ``loss_grid``). Every random
draw (the two samplers, Grid's jitter) comes from the ``torch.Generator``
it is given, through ``vps_torch.core.sampler.uniform``. Named ranges:
backbone_fpn, rpn, proposal_targets, bbox_head, mask_head (and grid).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn as nn

from vps_torch import resolve_device
from vps_torch.core import sampler
from vps_torch.core.targets import anchor_target, proposal_target
from vps_torch.models.bbox_head import get_det_bboxes
from vps_torch.models.mask_head import select_mask_channel
from vps_torch.models.mask_heads import (
    grid_bboxes,
    grid_target,
    mask_iou_target,
)
from vps_torch.models.rpn_head import RPNHead, rpn_proposals
from vps_torch.ops.anchors import AnchorGenerator
from vps_torch.ops.losses import (
    accuracy,
    binary_cross_entropy_with_logits,
    smooth_l1_loss,
    softmax_cross_entropy,
)
from vps_torch.ops.roi_align import multilevel_roi_align
from vps_torch.registry import (
    BACKBONES,
    DETECTORS,
    HEADS,
    NECKS,
    SHARED_HEADS,
    build_from_cfg,
)

# named ranges of predict's and loss's stages, read by torch.profiler
_stage = torch.profiler.record_function


def _build(cfg, registry, default_type=None, **default_args):
    return build_from_cfg(cfg, registry, default_args, default_type)


def jitter_offsets(generator, shape, device, amp: float):
    """Grid R-CNN's box jitter: U[-amp, amp) of ``shape`` from
    ``generator`` (JAX's ``jax.random.uniform(key, shape, minval=-amp,
    maxval=amp)``), through the samplers' ``uniform``."""
    return sampler.uniform(generator, shape, device) * (2.0 * amp) - amp


def bbox_losses(head, st, cls_score, bbox_pred):
    """The box head's terms on the sampled RoIs ``st``: ``loss_cls`` (cross
    entropy over the valid rows), ``acc`` and ``loss_bbox`` (smooth L1 of
    each row's deltas of its target label, over every row)."""
    avg = st.label_weights.sum().clamp(min=1.0)
    num = st.rois.shape[0]
    pred = bbox_pred
    if not head.reg_class_agnostic:
        pred = bbox_pred.reshape(num, -1, 4).gather(
            1, st.labels[:, None, None].expand(-1, 1, 4))[:, 0]
    return {"loss_cls": softmax_cross_entropy(cls_score, st.labels,
                                              weight=st.label_weights,
                                              avg_factor=avg),
            "acc": accuracy(cls_score, st.labels, valid=st.valid),
            "loss_bbox": smooth_l1_loss(pred, st.bbox_targets, beta=1.0,
                                        weight=st.bbox_weights,
                                        avg_factor=float(num))}


def mask_loss(pred_slice, mask_targets, pos_mask):
    """Per-pixel sigmoid cross entropy of the positive prefix's masks, mean
    over the valid positives' pixels."""
    num_pos = pos_mask.sum().clamp(min=1)
    msz = mask_targets.shape[-1]
    return binary_cross_entropy_with_logits(
        pred_slice, mask_targets, weight=pos_mask[:, None, None].float(),
        avg_factor=num_pos * float(msz * msz))


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

    def _rpn_loss(self, x, img_shape, gt_bboxes, gt_valid, losses,
                  generator):
        """The RPN head's anchor losses into ``losses``; returns the head's
        outputs and the anchors."""
        cls_outs, reg_outs = self.rpn_head(x)
        anchors = self._anchors_for(cls_outs)
        flat_anchors = torch.cat(anchors, 0)
        at = anchor_target(
            generator, flat_anchors,
            torch.ones(flat_anchors.shape[0], dtype=torch.bool,
                       device=self.device),
            gt_bboxes, gt_valid, img_shape, self.train_cfg["rpn"])
        flat_cls = torch.cat([c[0].permute(1, 2, 0).reshape(-1)
                              for c in cls_outs])
        flat_reg = torch.cat([r[0].permute(1, 2, 0).reshape(-1, 4)
                              for r in reg_outs])
        num_total = (at.num_pos + at.num_neg).clamp(min=1).float()
        losses["loss_rpn_cls"] = binary_cross_entropy_with_logits(
            flat_cls, at.labels.float(), weight=at.label_weights,
            avg_factor=num_total)
        losses["loss_rpn_bbox"] = smooth_l1_loss(
            flat_reg, at.bbox_targets, beta=1.0 / 9.0,
            weight=at.bbox_weights, avg_factor=num_total)
        return cls_outs, reg_outs, anchors

    def _rpn_losses_and_proposals(self, x, img_shape, gt_bboxes, gt_valid,
                                  losses, generator):
        """The anchor losses, and the train-time proposals as data (no
        gradient through them, JAX's stop_gradient)."""
        cls_outs, reg_outs, anchors = self._rpn_loss(
            x, img_shape, gt_bboxes, gt_valid, losses, generator)
        pcfg = self.train_cfg.get("rpn_proposal", {})
        with torch.no_grad():
            proposals, _, valid = rpn_proposals(
                [c[0].permute(1, 2, 0) for c in cls_outs],
                [r[0].permute(1, 2, 0) for r in reg_outs], anchors, img_shape,
                nms_pre=pcfg.get("nms_pre", 2000),
                nms_thr=pcfg.get("nms_thr", 0.7),
                max_num=pcfg.get("max_num", 2000))
        return proposals, valid

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
    hooks (``_bbox_forward``, ``_extra_mask_losses``, ``_extra_losses``,
    ``_extra_predict_mask``, ``_extra_predict``), the cascades the heads
    (``_setup_heads``) and ``loss``."""

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

    # -- training ----------------------------------------------------------

    def loss(self, img, gt_bboxes, gt_labels, gt_valid, gt_masks=None,
             proposals=None, proposal_valid=None,
             generator: Optional[torch.Generator] = None):
        """Loss terms of one image (1, H, W, 3): gt_bboxes (G, 4), gt_labels
        (G,) 1-based, gt_valid (G,), gt_masks (G, H, W) with a mask head;
        ``proposals`` (P, 4) and ``proposal_valid`` (P,) only without an RPN
        head (FastRCNN). Returns a dict of scalars."""
        losses = {}
        h, w = img.shape[1:3]
        with _stage("backbone_fpn"):
            x = self.extract_feat(img)
        if self.rpn_head is not None:
            with _stage("rpn"):
                proposals, proposal_valid = self._rpn_losses_and_proposals(
                    x, (h, w), gt_bboxes, gt_valid, losses, generator)
        if proposals is None:
            raise ValueError(f"{type(self).__name__} has no RPN head: loss "
                             f"needs proposals")
        with _stage("proposal_targets"):
            st = proposal_target(
                generator, proposals, proposal_valid, gt_bboxes, gt_labels,
                gt_valid, self.train_cfg["rcnn"],
                gt_masks=gt_masks if self.mask_head is not None else None,
                target_means=self.bbox_head.target_means,
                target_stds=self.bbox_head.target_stds)
        with _stage("bbox_head"):
            (cls_score, bbox_pred), _ = self._bbox_forward(x, st.rois,
                                                           st.valid)
            losses.update(bbox_losses(self.bbox_head, st, cls_score,
                                      bbox_pred))
        if self.mask_head is not None:
            with _stage("mask_head"):  # on the positive prefix
                n_pos_max = st.mask_targets.shape[0]
                pos_mask = st.pos_mask[:n_pos_max]
                mask_feats = self._roi_feats(x, st.rois[:n_pos_max], "mask",
                                             valid=pos_mask)
                mask_pred = self.mask_head(mask_feats)
                losses["loss_mask"] = mask_loss(
                    select_mask_channel(mask_pred, st.labels[:n_pos_max]),
                    st.mask_targets, pos_mask)
                self._extra_mask_losses(losses, st, mask_feats, mask_pred,
                                        gt_masks)
        self._extra_losses(losses, x, st, (h, w), gt_bboxes, gt_valid,
                           generator)
        return losses

    def _extra_mask_losses(self, losses, st, mask_feats, mask_pred, gt_masks):
        """Hook after the mask loss (MaskScoringRCNN)."""

    def _extra_losses(self, losses, x, st, img_shape, gt_bboxes, gt_valid,
                      generator):
        """Hook after the box and mask losses (GridRCNN)."""

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
    """No RPN head: loss and predict take precomputed proposals."""


@DETECTORS.register
class RPN(_Trunk):
    """Proposals only: backbone (+ neck) + RPNHead; its loss is the anchor
    losses."""

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

    def loss(self, img, gt_bboxes, gt_valid,
             generator: Optional[torch.Generator] = None):
        """The anchor losses of one image: ``loss_rpn_cls``,
        ``loss_rpn_bbox`` (no proposal decode)."""
        losses = {}
        with _stage("backbone_fpn"):
            x = self.extract_feat(img)
        with _stage("rpn"):
            self._rpn_loss(x, tuple(img.shape[1:3]), gt_bboxes, gt_valid,
                           losses, generator)
        return losses

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

    def _extra_mask_losses(self, losses, st, mask_feats, mask_pred, gt_masks):
        """MSE of the predicted IoU of each positive's target class (label,
        not label + 1 as in predict) against mask_iou_target."""
        n_pos_max = st.mask_targets.shape[0]
        pos_labels = st.labels[:n_pos_max]
        pos_mask = st.pos_mask[:n_pos_max]
        pred_slice = select_mask_channel(mask_pred, pos_labels)
        iou_pred = self.mask_iou_head(mask_feats, pred_slice)
        pos_iou_pred = iou_pred.gather(1, pos_labels[:, None])[:, 0]
        thr = (self.train_cfg or {}).get("rcnn", {}).get("mask_thr_binary",
                                                          0.5)
        targets = mask_iou_target(
            st.rois[:n_pos_max], st.pos_gt_idx[:n_pos_max], pos_mask,
            gt_masks, pred_slice.detach(), st.mask_targets, thr=thr)
        losses["loss_mask_iou"] = self.mask_iou_head.loss(pos_iou_pred,
                                                          targets, pos_mask)

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

    def _extra_losses(self, losses, x, st, img_shape, gt_bboxes, gt_valid,
                      generator):
        """The grid heatmaps' loss on the positive prefix, capped at
        max_num_grid, each box jittered by up to 15% (one (n, 4) draw) and
        clipped to the image."""
        with _stage("grid"):
            rc = self.train_cfg["rcnn"]
            n_pos_max = min(int(st.rois.shape[0]
                                * rc["sampler"]["pos_fraction"]),
                            rc.get("max_num_grid", 192))
            pos_rois = st.rois[:n_pos_max]
            pos_mask = st.pos_mask[:n_pos_max]
            offs = jitter_offsets(generator, (n_pos_max, 4), pos_rois.device,
                                  0.15)
            cxcy = (pos_rois[:, 2:4] + pos_rois[:, :2]) / 2
            wh = (pos_rois[:, 2:4] - pos_rois[:, :2]).abs()
            new_c = cxcy + wh * offs[:, :2]
            new_wh = wh * (1 + offs[:, 2:])
            hh, ww = img_shape
            top = torch.tensor([ww - 1, hh - 1, ww - 1, hh - 1],
                               dtype=torch.float32, device=pos_rois.device)
            jit = torch.minimum(torch.cat([new_c - new_wh / 2,
                                           new_c + new_wh / 2], -1)
                                .clamp(min=0.0), top)
            fused, unfused = self.grid_head(
                self._pool(x, jit, self.grid_roi_cfg, 14, pos_mask,
                           shared=False), train=True)
            targets = grid_target(
                jit, gt_bboxes[st.pos_gt_idx[:n_pos_max]], pos_mask,
                grid_points=self.grid_head.grid_points,
                roi_feat_size=self.grid_head.roi_feat_size,
                pos_radius=rc.get("pos_radius", 1))
            losses["loss_grid"] = self.grid_head.loss(fused, unfused, targets,
                                                      pos_mask)

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
