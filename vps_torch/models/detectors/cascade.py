"""Cascade R-CNN and Hybrid Task Cascade (port of
vps_tpu/models/detectors/cascade.py).

Stage math as in JAX: each stage's box head scores the RoIs the stage
before refined (``regress_by_class`` on its predicted labels, invalid rows
zeroed); the detections take the mean of the stages' class logits and the
last stage's deltas; masks are the logit of the mean of the stages'
sigmoids. HTC adds its fused semantic branch (pooled semantic features
summed into the box and mask windows) and the mask information flow (each
stage's mask head fed the previous heads' features). A per-stage config
list, or one config shared by every stage (separate parameters), builds
``bbox_head.{i}`` / ``mask_head.{i}`` as in mmdet's state_dicts; HTC adds
``semantic_head``. Named ranges: backbone_fpn, rpn, semantic_head (HTC),
bbox_dets, mask.

``loss``, as JAX's: each stage samples its own RoIs from the proposals the
stage before refined (rising IoU thresholds, the stage's ``rcnn`` config),
its terms keyed ``s{i}.`` and weighted by ``stage_loss_weights``; between
stages the sampled RoIs are decoded with their target labels' detached
deltas and the rows that came from the gt are dropped. HTC adds the
semantic loss and, interleaved, refines and samples again before each
stage's mask branch (two draws a stage). Named ranges as in the two-stage
``loss`` (proposal_targets, bbox_head, mask_head once a stage).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import torch
import torch.nn as nn

from vps_torch.core.targets import proposal_target
from vps_torch.models.bbox_head import get_det_bboxes, regress_by_class
from vps_torch.models.detectors.two_stage import (
    FasterRCNN,
    _build,
    _stage,
    bbox_losses,
    mask_loss,
)
from vps_torch.models.layers import avg_pool, resize_bilinear
from vps_torch.models.mask_head import select_mask_channel
from vps_torch.ops.roi_align import multilevel_roi_align
from vps_torch.registry import DETECTORS, HEADS


def _per_stage(cfg, num_stages):
    if cfg is None:
        return [None] * num_stages
    if isinstance(cfg, (list, tuple)):
        assert len(cfg) == num_stages, (len(cfg), num_stages)
        return list(cfg)
    return [cfg] * num_stages


def _logit_of_mean(prob_sum, n: int):
    mean = (prob_sum / n).clamp(1e-6, 1.0 - 1e-6)
    return torch.log(mean) - torch.log1p(-mean)


@DETECTORS.register
class CascadeRCNN(FasterRCNN):
    """Multi-stage refinement detector: bbox_head / bbox_roi_extractor /
    mask_head / mask_roi_extractor take one config (each stage its own
    parameters) or a per-stage list."""

    def __init__(self, *args, num_stages: int = 3, **kwargs):
        self.num_stages = num_stages
        super().__init__(*args, **kwargs)

    def _mask_head_args(self, i: int, cfg) -> Dict[str, Any]:
        """Hook: extra arguments of stage i's mask head (HTC's conv_res)."""
        return {}

    def _setup_heads(self, cfgs, dev):
        n = self.num_stages
        self.bbox_head = nn.ModuleList(
            _build(c, HEADS, "SharedFCBBoxHead", device=dev)
            for c in _per_stage(cfgs["bbox_head"], n))
        self.bbox_roi_cfgs = [dict(c or {}) for c in
                              _per_stage(cfgs["bbox_roi_extractor"], n)]
        self.mask_head = None
        if cfgs["mask_head"] is not None:
            self.mask_head = nn.ModuleList(
                _build(c, HEADS, "FCNMaskHead", device=dev,
                       **self._mask_head_args(i, c))
                for i, c in enumerate(_per_stage(cfgs["mask_head"], n)))
            self.mask_roi_cfgs = [
                dict(c) if c else self.bbox_roi_cfgs[i] for i, c in
                enumerate(_per_stage(cfgs["mask_roi_extractor"], n))]

    def _stage_bbox_forward(self, i, x, rois, valid, semantic_feat=None):
        feats = self._pool(x, rois, self.bbox_roi_cfgs[i], 7, valid)
        feats = self._fuse_semantic(feats, rois, semantic_feat, "bbox")
        return self.bbox_head[i](feats)

    def _fuse_semantic(self, feats, rois, semantic_feat, branch):
        """HTC's hook: nothing for a plain cascade."""
        return feats

    def _semantic_feat(self, x):
        return None

    # -- training ----------------------------------------------------------

    def _stage_weights(self):
        return list(self.train_cfg.get(
            "stage_loss_weights", [1.0, 0.5, 0.25][:self.num_stages]))

    def _stage_bbox_losses(self, i, losses, lw, st, cls_score, bbox_pred):
        terms = bbox_losses(self.bbox_head[i], st, cls_score, bbox_pred)
        losses[f"s{i}.loss_cls"] = lw * terms["loss_cls"]
        losses[f"s{i}.acc"] = terms["acc"]
        losses[f"s{i}.loss_bbox"] = lw * terms["loss_bbox"]

    def _stage_mask_pred(self, i, mask_feats):
        """Hook: stage i's mask logits (HTC chains the information flow)."""
        return self.mask_head[i](mask_feats)

    def _stage_mask_loss(self, i, x, st, semantic_feat=None):
        n_pos_max = st.mask_targets.shape[0]
        pos_rois = st.rois[:n_pos_max]
        pos_mask = st.pos_mask[:n_pos_max]
        feats = self._pool(x, pos_rois, self.mask_roi_cfgs[i], 14, pos_mask)
        feats = self._fuse_semantic(feats, pos_rois, semantic_feat, "mask")
        return mask_loss(select_mask_channel(self._stage_mask_pred(i, feats),
                                             st.labels[:n_pos_max]),
                         st.mask_targets, pos_mask)

    def _refine(self, i, st, bbox_pred, img_shape):
        """The next stage's proposals: the sampled RoIs decoded with the
        detached deltas of their TARGET labels; rows not valid or from the
        gt dropped (zeroed and invalid)."""
        head = self.bbox_head[i]
        refined = regress_by_class(
            st.rois, st.labels, bbox_pred.detach(), img_shape,
            head.target_means, head.target_stds, head.reg_class_agnostic)
        valid = st.valid & ~st.from_gt
        return torch.where(valid[:, None], refined,
                           torch.zeros_like(refined)), valid

    def _stage_targets(self, generator, i, proposals, proposal_valid,
                       gt_bboxes, gt_labels, gt_valid, gt_masks, rc):
        head = self.bbox_head[i]
        with _stage("proposal_targets"):
            return proposal_target(
                generator, proposals, proposal_valid, gt_bboxes, gt_labels,
                gt_valid, rc,
                gt_masks=gt_masks if self.mask_head is not None else None,
                target_means=head.target_means, target_stds=head.target_stds)

    def _trunk_losses(self, img, gt_bboxes, gt_valid, proposals,
                      proposal_valid, losses, generator):
        """The pyramid, and the RPN's losses and proposals (or the given
        ones)."""
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
        return x, proposals, proposal_valid

    def loss(self, img, gt_bboxes, gt_labels, gt_valid, gt_masks=None,
             proposals=None, proposal_valid=None,
             generator: Optional[torch.Generator] = None):
        """Loss terms of one image, as FasterRCNN's ``loss`` takes them:
        the RPN's, then each stage's ``s{i}.loss_cls``, ``s{i}.acc``,
        ``s{i}.loss_bbox`` (and ``s{i}.loss_mask``)."""
        losses = {}
        h, w = img.shape[1:3]
        x, proposals, proposal_valid = self._trunk_losses(
            img, gt_bboxes, gt_valid, proposals, proposal_valid, losses,
            generator)
        rcnn_cfgs = _per_stage(self.train_cfg["rcnn"], self.num_stages)
        lws = self._stage_weights()
        for i in range(self.num_stages):
            st = self._stage_targets(generator, i, proposals, proposal_valid,
                                     gt_bboxes, gt_labels, gt_valid, gt_masks,
                                     rcnn_cfgs[i])
            with _stage("bbox_head"):
                cls_score, bbox_pred = self._stage_bbox_forward(
                    i, x, st.rois, st.valid)
                self._stage_bbox_losses(i, losses, lws[i], st, cls_score,
                                        bbox_pred)
            if self.mask_head is not None:
                with _stage("mask_head"):
                    losses[f"s{i}.loss_mask"] = lws[i] * self._stage_mask_loss(
                        i, x, st)
            if i < self.num_stages - 1:
                proposals, proposal_valid = self._refine(i, st, bbox_pred,
                                                         (h, w))
        return losses

    # -- inference ---------------------------------------------------------

    @torch.inference_mode()
    def predict(self, img, proposals=None, proposal_valid=None):
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
        semantic_feat = self._semantic_feat(x)

        with _stage("bbox_dets"):
            rois, valid = proposals, proposal_valid
            ms_scores = []
            for i in range(self.num_stages):
                cls_score, bbox_pred = self._stage_bbox_forward(
                    i, x, rois, valid, semantic_feat)
                ms_scores.append(cls_score)
                if i < self.num_stages - 1:
                    head = self.bbox_head[i]
                    rois = regress_by_class(
                        rois, cls_score.argmax(-1), bbox_pred, (h, w),
                        head.target_means, head.target_stds,
                        head.reg_class_agnostic)
                    rois = torch.where(valid[:, None], rois,
                                       torch.zeros_like(rois))
            cls_score = sum(ms_scores) / float(self.num_stages)
            last = self.bbox_head[-1]
            rcnn = tcfg.get("rcnn", {})
            dets, labels, det_valid = get_det_bboxes(
                rois, cls_score, bbox_pred, (h, w),
                score_thr=rcnn.get("score_thr", 0.05),
                nms_iou_thr=rcnn.get("nms", {}).get("iou_thr", 0.5),
                max_per_img=rcnn.get("max_per_img", 100),
                target_means=last.target_means, target_stds=last.target_stds,
                valid=valid.float(), nms_cfg=rcnn.get("nms"))
        out = {"det_bboxes": dets, "det_labels": labels,
               "det_valid": det_valid}
        if self.mask_head is not None:
            with _stage("mask"):
                out["mask_logits"] = self._predict_masks(
                    x, dets, labels, det_valid, semantic_feat)
        return out

    def _predict_masks(self, x, dets, labels, det_valid, semantic_feat):
        """Each stage's mask head on its own window of the final boxes; the
        logit of the mean of their sigmoids (mmdet's merge_aug_masks)."""
        prob_sum = None
        for i in range(self.num_stages):
            feats = self._pool(x, dets[:, :4], self.mask_roi_cfgs[i], 14,
                               det_valid)
            feats = self._fuse_semantic(feats, dets[:, :4], semantic_feat,
                                        "mask")
            prob = torch.sigmoid(select_mask_channel(self.mask_head[i](feats),
                                                     labels + 1))
            prob_sum = prob if prob_sum is None else prob_sum + prob
        return _logit_of_mean(prob_sum, self.num_stages)


@DETECTORS.register
class HybridTaskCascade(CascadeRCNN):
    """HTC: a cascade with the fused semantic branch (``semantic_head`` may
    be None), semantic features summed into the RoI windows of the
    branches in ``semantic_fusion``, and mask information flow.
    ``interleaved`` changes only training."""

    def __init__(self, *args,
                 semantic_roi_extractor: Optional[Dict[str, Any]] = None,
                 semantic_head: Optional[Dict[str, Any]] = None,
                 semantic_fusion: Sequence[str] = ("bbox", "mask"),
                 interleaved: bool = True, mask_info_flow: bool = True,
                 **kwargs):
        self._semantic_cfgs = (semantic_roi_extractor, semantic_head)
        self.semantic_fusion = tuple(semantic_fusion)
        self.interleaved = interleaved
        self.mask_info_flow = mask_info_flow
        super().__init__(*args, **kwargs)

    def _mask_head_args(self, i, cfg):
        # stage i > 0 gets the previous heads' features only with the flow
        if dict(cfg).get("type") == "HTCMaskHead":
            return {"with_conv_res": self.mask_info_flow and i > 0}
        return {}

    def _setup_heads(self, cfgs, dev):
        super()._setup_heads(cfgs, dev)
        roi_cfg, head_cfg = self._semantic_cfgs
        self.semantic_head = (_build(head_cfg, HEADS, "FusedSemanticHead",
                                     device=dev) if head_cfg else None)
        self.semantic_roi_cfg = dict(roi_cfg or {})

    def _semantic_feat(self, x):
        if self.semantic_head is None:
            return None
        with _stage("semantic_head"):
            _, feat = self.semantic_head(list(x[:self.semantic_head.num_ins]))
        return feat

    def _fuse_semantic(self, feats, rois, semantic_feat, branch):
        """Add the semantic embedding pooled over each RoI (one level, no
        validity mask), brought to the window's size by average pooling
        (or a bilinear resize when the sizes are not multiples)."""
        if semantic_feat is None or branch not in self.semantic_fusion:
            return feats
        strides = self.semantic_roi_cfg.get("featmap_strides", [8])
        layer = self.semantic_roi_cfg.get("roi_layer", {})
        sem = multilevel_roi_align(
            [semantic_feat[0].permute(1, 2, 0)], rois, strides[:1],
            layer.get("out_size", 14), layer.get("sample_num", 2))
        if sem.shape[1] != feats.shape[1]:
            sem = sem.permute(0, 3, 1, 2)
            factor = sem.shape[-1] // feats.shape[1]
            if factor * feats.shape[1] == sem.shape[-1]:
                sem = avg_pool(sem, factor, factor, 0)
            else:
                sem = resize_bilinear(sem, tuple(feats.shape[1:3]))
            sem = sem.permute(0, 2, 3, 1)
        return feats + sem

    def _stage_mask_pred(self, i, mask_feats):
        """Stage i's mask logits; with the information flow, the features
        of heads 0..i-1 chained into it through their ``conv_res``."""
        if not self.mask_info_flow:
            return self.mask_head[i](mask_feats, return_feat=False)
        last_feat = None
        for j in range(i):
            last_feat = self.mask_head[j](mask_feats, last_feat,
                                          return_logits=False)
        return self.mask_head[i](mask_feats, last_feat, return_feat=False)

    def loss(self, img, gt_bboxes, gt_labels, gt_valid, gt_masks=None,
             gt_semantic_seg=None, proposals=None, proposal_valid=None,
             generator: Optional[torch.Generator] = None):
        """CascadeRCNN's terms, and ``loss_semantic_seg`` when there is a
        semantic head and ``gt_semantic_seg`` (1, h, w) int at its fused
        resolution (stride 8). Interleaved: each stage refines and samples
        again before its mask branch; otherwise it refines after."""
        losses = {}
        h, w = img.shape[1:3]
        x, proposals, proposal_valid = self._trunk_losses(
            img, gt_bboxes, gt_valid, proposals, proposal_valid, losses,
            generator)
        semantic_feat = None
        if self.semantic_head is not None:
            with _stage("semantic_head"):
                semantic_pred, semantic_feat = self.semantic_head(
                    list(x[:self.semantic_head.num_ins]))
                if gt_semantic_seg is not None:
                    losses["loss_semantic_seg"] = self.semantic_head.loss(
                        semantic_pred, gt_semantic_seg)
        rcnn_cfgs = _per_stage(self.train_cfg["rcnn"], self.num_stages)
        lws = self._stage_weights()
        for i in range(self.num_stages):
            args = (gt_bboxes, gt_labels, gt_valid, gt_masks, rcnn_cfgs[i])
            st = self._stage_targets(generator, i, proposals, proposal_valid,
                                     *args)
            with _stage("bbox_head"):
                cls_score, bbox_pred = self._stage_bbox_forward(
                    i, x, st.rois, st.valid, semantic_feat)
                self._stage_bbox_losses(i, losses, lws[i], st, cls_score,
                                        bbox_pred)
            if self.mask_head is not None:
                mask_st = st
                if self.interleaved:
                    proposals, proposal_valid = self._refine(
                        i, st, bbox_pred, (h, w))
                    mask_st = self._stage_targets(
                        generator, i, proposals, proposal_valid, *args)
                with _stage("mask_head"):
                    losses[f"s{i}.loss_mask"] = lws[i] * self._stage_mask_loss(
                        i, x, mask_st, semantic_feat)
            if i < self.num_stages - 1 and not self.interleaved:
                proposals, proposal_valid = self._refine(i, st, bbox_pred,
                                                         (h, w))
        return losses

    def _predict_masks(self, x, dets, labels, det_valid, semantic_feat):
        """One window from the last stage's extractor; the stages' heads
        chained through the information flow; the logit of the mean of
        their sigmoids."""
        feats = self._pool(x, dets[:, :4], self.mask_roi_cfgs[-1], 14,
                           det_valid)
        feats = self._fuse_semantic(feats, dets[:, :4], semantic_feat, "mask")
        prob_sum, last_feat = None, None
        for i in range(self.num_stages):
            if self.mask_info_flow:
                mask_pred, last_feat = self.mask_head[i](feats, last_feat)
            else:
                mask_pred = self.mask_head[i](feats, return_feat=False)
            prob = torch.sigmoid(select_mask_channel(mask_pred, labels + 1))
            prob_sum = prob if prob_sum is None else prob_sum + prob
        return _logit_of_mean(prob_sum, self.num_stages)


DETECTORS.register(HybridTaskCascade, name="HTC")
