"""The VPSNet detector (port of vps_tpu/models/detectors/panoptic.py:
PanopticFuseTrack with its loss, _panoptic_train_loss, predict and
predict_video).

Same per-frame contract as the JAX detector: ``predict`` takes a (1, H, W, 3)
normalised float frame, its reference frame and the TrackState, and returns
the same output dict with the same fixed capacities and validity masks
(proposals max_num, det max_det, track memory) plus the new TrackState; it
runs under ``inference_mode``. ``loss`` takes one training sample with its
padded gt and returns the same loss dict as JAX's ``loss``; the sampler's
draws come from the ``torch.Generator`` it is given. Submodule names are the
mmdet state_dict prefixes (``backbone``, ``neck``, ``extra_neck``,
``rpn_head``, ``bbox_head``, ``mask_head``, ``panopticFPN``, ``track_head``,
``flownet2``); a detector without a tower has no such keys. Every parameter
trains except FlowNet2's and, for ``frozen_stages = s``, the backbone's stem
and stages 1..s.

Without a track head the detections' object ids are the running count of
the frame's valid detections and the TrackState passes through unchanged;
without a fuse neck the features are the plain FPN pyramid and no flow is
computed.
"""

from __future__ import annotations

import contextlib
import copy
import re
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from reference.vpsref import resolve_device
from reference.vpsref.core.targets import anchor_target, proposal_target
from reference.vpsref.models.bbox_head import SharedFCBBoxHead
from reference.vpsref.models.bfp_tcea import BFPTcea
from reference.vpsref.models.detectors.panoptic_ops import (
    TrackState,
    _paste_logit_window,
    _seg_window,
    mask_removal_and_fuse,
    panoptic_dets,
    track_assign,
)
from reference.vpsref.models.flow.flownet2 import FlowNet2, TinyFlowNet
from reference.vpsref.models.fpn import FPN
from reference.vpsref.models.layers import compute_dtype, resize_bilinear
from reference.vpsref.models.mask_head import FCNMaskHead
from reference.vpsref.models.panoptic_fpn import UPSNetFPN
from reference.vpsref.models.resnet import ResNet
from reference.vpsref.models.rpn_head import RPNHead, rpn_proposals
from reference.vpsref.models.track_head import (
    TrackHead,
    compute_comp_scores,
    track_match_loss,
)
from reference.vpsref.ops.anchors import AnchorGenerator
from reference.vpsref.ops.box import bbox_overlaps
from reference.vpsref.ops.losses import (
    accuracy,
    binary_cross_entropy_with_logits,
    smooth_l1_loss,
    softmax_cross_entropy,
)
from reference.vpsref.ops.roi_align import multilevel_roi_align
from reference.vpsref.registry import DETECTORS

IMG_MEAN = np.asarray([123.675, 116.28, 103.53], np.float32)
IMG_STD = np.asarray([58.395, 57.12, 57.375], np.float32)


# named ranges of predict's stages, read by torch.profiler (reference.vpsref.profile)
_stage = torch.profiler.record_function


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


class PanopticFuseTrack(nn.Module):
    """Flow-fused, tracking panoptic detector, built from the zoo config
    dicts (``zoo.fusetrack_model_cfg()`` minus ``type``). ``extra_neck`` and
    ``track_head`` are optional, as in JAX; ``with_flow=False`` builds no
    FlowNet2 (and then takes no fuse neck)."""

    def __init__(self, backbone: Dict[str, Any], neck: Dict[str, Any],
                 rpn_head: Dict[str, Any], bbox_head: Dict[str, Any],
                 mask_head: Dict[str, Any], panoptic: Dict[str, Any],
                 test_cfg: Dict[str, Any],
                 extra_neck: Optional[Dict[str, Any]] = None,
                 track_head: Optional[Dict[str, Any]] = None,
                 train_cfg: Optional[Dict[str, Any]] = None,
                 bbox_roi_extractor: Optional[Dict[str, Any]] = None,
                 mask_roi_extractor: Optional[Dict[str, Any]] = None,
                 flow: Optional[Dict[str, Any]] = None,
                 flow_input_scale: float = 0.5, with_flow: bool = True,
                 device="cuda"):
        super().__init__()
        dev = resolve_device(device)
        if extra_neck is not None and not with_flow:
            raise ValueError("the fuse neck (extra_neck) needs the flow: "
                             "with_flow=False takes extra_neck=None")
        self.test_cfg = test_cfg
        self.train_cfg = train_cfg
        self.flow_input_scale = flow_input_scale
        bdt = compute_dtype(backbone.get("compute_dtype"))
        self.backbone = ResNet(backbone.get("depth", 50),
                               backbone.get("num_stages", 4),
                               backbone.get("out_indices", (0, 1, 2, 3)),
                               frozen_stages=backbone.get("frozen_stages", -1),
                               dtype=bdt, device=dev)
        self.neck = FPN(neck.get("in_channels", (256, 512, 1024, 2048)),
                        neck.get("out_channels", 256),
                        neck.get("num_outs", 5), dtype=bdt, device=dev)
        self.extra_neck = None
        if extra_neck is not None:
            kind = extra_neck.get("type", "BFPTcea")
            if kind != "BFPTcea":
                raise ValueError(f"unknown extra_neck type {kind!r}")
            # the detector fuses 2 frames, [current, reference], whatever the
            # config's nframes: JAX's detector calls either neck without next
            # frames, and flax sizes the TCEA's convs from that input
            self.extra_neck = BFPTcea(
                in_channels=extra_neck.get("in_channels", 256),
                num_levels=extra_neck.get("num_levels", 5),
                refine_level=extra_neck.get("refine_level", 0),
                refine_type=extra_neck.get("refine_type", "conv"),
                nframes=2, center=extra_neck.get("center", 0),
                compute_dtype=compute_dtype(extra_neck.get("compute_dtype"),
                                            torch.bfloat16),
                warp_sampling=extra_neck.get("warp_sampling", "bilinear"),
                device=dev)
        self.anchor_scales = list(rpn_head.get("anchor_scales", [8]))
        self.anchor_ratios = list(rpn_head.get("anchor_ratios", [0.5, 1.0, 2.0]))
        self.anchor_strides = list(rpn_head.get("anchor_strides",
                                                [4, 8, 16, 32, 64]))
        self.rpn_head = RPNHead(
            rpn_head.get("in_channels", 256), rpn_head.get("feat_channels", 256),
            len(self.anchor_scales) * len(self.anchor_ratios), device=dev)
        self.bbox_head = SharedFCBBoxHead(
            bbox_head.get("num_fcs", 2), bbox_head.get("in_channels", 256),
            bbox_head.get("fc_out_channels", 1024),
            bbox_head.get("roi_feat_size", 7), bbox_head.get("num_classes", 9),
            bbox_head.get("reg_class_agnostic", False), device=dev)
        self.bbox_target_means = tuple(bbox_head.get("target_means", (0.0,) * 4))
        self.bbox_target_stds = tuple(bbox_head.get("target_stds",
                                                    (0.1, 0.1, 0.2, 0.2)))
        self.mask_head = FCNMaskHead(
            mask_head.get("num_convs", 4), mask_head.get("in_channels", 256),
            mask_head.get("conv_out_channels", 256),
            mask_head.get("num_classes", 9), device=dev)
        self.panopticFPN = UPSNetFPN(
            panoptic.get("in_channels", 256), panoptic.get("out_channels", 128),
            panoptic.get("num_levels", 4),
            panoptic.get("num_things_classes", 8),
            panoptic.get("num_classes", 19),
            dcn_sampling=panoptic.get("dcn_sampling", "bilinear"),
            head_stride=panoptic.get("head_stride", 4),
            compute_dtype=compute_dtype(panoptic.get("compute_dtype"),
                                        torch.bfloat16),
            device=dev)
        self.track_head = None
        if track_head is not None:
            self.track_head = TrackHead(
                track_head.get("num_fcs", 2), track_head.get("in_channels", 256),
                track_head.get("roi_feat_size", 7),
                track_head.get("fc_out_channels", 1024), device=dev)
            self.match_coeff = tuple(track_head.get("match_coeff",
                                                    (1.0, 2.0, 10.0)))
            self.loss_match_weight = float(
                track_head.get("loss_match", {}).get("loss_weight", 1.0))
        flow = flow or {}
        self.flownet2 = None
        if with_flow and flow.get("type") == "TinyFlow":
            self.flownet2 = TinyFlowNet(device=dev)
        elif with_flow:
            self.flownet2 = FlowNet2(
                compute_dtype=compute_dtype(flow.get("compute_dtype"),
                                            torch.bfloat16), device=dev)
        # every RoI (7x7 and 14x14) samples with bbox_roi_extractor's
        # settings, as in the JAX detector; mask_roi_extractor is accepted
        # for config compatibility
        self.bbox_roi_cfg = dict(bbox_roi_extractor or {})
        self.device = dev
        self.register_buffer("img_mean", torch.from_numpy(IMG_MEAN).to(dev),
                             persistent=False)
        self.register_buffer("img_std", torch.from_numpy(IMG_STD).to(dev),
                             persistent=False)
        self.eval()  # frozen BN, no dropout: training and inference alike
        if self.flownet2 is not None:
            self.flownet2.requires_grad_(False)

    # ------------------------------------------------------------------
    # shared pieces
    # ------------------------------------------------------------------

    def extract_feat(self, img):
        """img (B, H, W, 3) -> FPN pyramid, tuple of (B, 256, H_l, W_l) f32."""
        return self.neck(self.backbone(_nchw(img)))

    def compute_flow(self, img, ref_img, scale_factor: float = 0.25):
        """Denormalise, optionally downscale by flow_input_scale, pad to a
        multiple of 64, FlowNet2, trim, resize to h * scale_factor and
        rescale the flow values. Returns (B, oh, ow, 2)."""
        rgb = img * self.img_std + self.img_mean
        ref_rgb = ref_img * self.img_std + self.img_mean
        h, w = img.shape[1:3]
        fis = self.flow_input_scale
        if fis != 1.0:
            fh, fw = int(round(h * fis)), int(round(w * fis))
            rgb = _nhwc(resize_bilinear(_nchw(rgb), (fh, fw)))
            ref_rgb = _nhwc(resize_bilinear(_nchw(ref_rgb), (fh, fw)))
        else:
            fh, fw = h, w
        pad = (0, 0, 0, (-fw) % 64, 0, (-fh) % 64)
        with torch.no_grad():  # JAX's stop_gradient: FlowNet2 is frozen data
            flow = self.flownet2(F.pad(rgb, pad), F.pad(ref_rgb, pad))
        flow = flow[:, :fh, :fw, :]
        if scale_factor != fis:
            oh, ow = int(round(h * scale_factor)), int(round(w * scale_factor))
            flow = _nhwc(resize_bilinear(_nchw(flow), (oh, ow))) * (
                scale_factor / fis)
        return flow

    def _roi_feats(self, feats, rois, out_size, valid=None):
        strides = self.bbox_roi_cfg.get("featmap_strides", [4, 8, 16, 32])
        roi_layer = self.bbox_roi_cfg.get("roi_layer", {})
        roi_dt = compute_dtype(self.bbox_roi_cfg.get("compute_dtype"),
                               torch.bfloat16) or torch.float32
        return multilevel_roi_align(
            [f[0].to(roi_dt).permute(1, 2, 0) for f in feats[:len(strides)]],
            rois, strides, out_size, roi_layer.get("sample_num", 2),
            valid=valid, sampling=roi_layer.get("sampling", "bilinear"))

    def _anchors_for(self, cls_outs):
        anchors = []
        for lvl, stride in enumerate(self.anchor_strides):
            gen = AnchorGenerator(stride, self.anchor_scales, self.anchor_ratios)
            anchors.append(gen.grid_anchors(tuple(cls_outs[lvl].shape[-2:]),
                                            stride, device=self.device))
        return anchors

    @property
    def uses_ref_feats(self) -> bool:
        """Whether inference reads the reference frame's pyramid (the fuse
        neck does; without it ``predict`` ignores ``ref_feats``)."""
        return self.extra_neck is not None

    def _fused_feats(self, img, ref_img, ref_feats=None, want_ref=False):
        """Backbone (x2 at video starts, x1 in steady state), flow and the
        fuse neck. Returns (fused feats, ref feats, plain current feats).
        Without a fuse neck the feats are the plain pyramid and the ref
        feats are computed only for ``want_ref`` (else None)."""
        with _stage("backbone_fpn"):
            x = self.extract_feat(img)
            ref_x = None
            if self.extra_neck is not None or want_ref:
                ref_x = (ref_feats if ref_feats is not None
                         else self.extract_feat(ref_img))
        if self.extra_neck is None:
            return x, ref_x, x
        with _stage("flownet2"):
            flow = self.compute_flow(img, ref_img, 0.25)
        with _stage("fuse_neck"):
            return self.extra_neck(x, ref_x, flow), ref_x, x

    # ------------------------------------------------------------------
    # training, one sample (panoptic_fusetrack.py:147-353)
    # ------------------------------------------------------------------

    def loss(self, img, ref_img, gt_bboxes, gt_labels, gt_valid, gt_masks,
             gt_semantic_seg, gt_semantic_seg_Nx, gt_pids, ref_bboxes,
             ref_valid, generator: Optional[torch.Generator] = None):
        """Loss terms of one sample. img, ref_img (1, H, W, 3); gt_* padded
        to G boxes with ``gt_valid``; gt_masks (G, H, W); gt_semantic_seg
        (1, H, W) and gt_semantic_seg_Nx (1, H/4, W/4) int, 255 ignored;
        ref_bboxes / ref_valid the reference frame's boxes. Returns a dict of
        scalars: the ``loss_*`` terms and the ``acc`` / ``match_acc``
        metrics."""
        losses = {}
        tc = self.train_cfg
        h, w = img.shape[1:3]
        x, ref_x, _ = self._fused_feats(
            img, ref_img, want_ref=self.track_head is not None)

        with _stage("semantic_head"):
            fcn_output, fcn_score = self.panopticFPN(
                list(x[:self.panopticFPN.num_levels]))
            losses["loss_segm"] = softmax_cross_entropy(
                _nhwc(fcn_output), gt_semantic_seg, ignore_index=255)

        with _stage("rpn"):
            cls_outs, reg_outs = self.rpn_head(x)
            anchors = self._anchors_for(cls_outs)
            flat_anchors = torch.cat(anchors, 0)
            at = anchor_target(
                generator, flat_anchors,
                torch.ones(flat_anchors.shape[0], dtype=torch.bool,
                           device=self.device),
                gt_bboxes, gt_valid, (h, w), tc["rpn"])
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

            # proposals are data: no gradient through their selection
            pcfg = tc.get("rpn_proposal", {})
            with torch.no_grad():
                proposals, _, prop_valid = rpn_proposals(
                    [c[0].permute(1, 2, 0) for c in cls_outs],
                    [r[0].permute(1, 2, 0) for r in reg_outs], anchors, (h, w),
                    nms_pre=pcfg.get("nms_pre", 2000),
                    nms_thr=pcfg.get("nms_thr", 0.7),
                    max_num=pcfg.get("max_num", 2000))
        with _stage("proposal_targets"):
            rc = tc["rcnn"]
            st = proposal_target(
                generator, proposals, prop_valid, gt_bboxes, gt_labels,
                gt_valid, rc, gt_pids=gt_pids, gt_masks=gt_masks,
                target_means=self.bbox_target_means,
                target_stds=self.bbox_target_stds)

        with _stage("bbox_head"):
            bbox_feats = self._roi_feats(x, st.rois, 7, valid=st.valid)
            cls_score, bbox_pred = self.bbox_head(bbox_feats)
            avg_cls = st.label_weights.sum().clamp(min=1.0)
            losses["loss_cls"] = softmax_cross_entropy(
                cls_score, st.labels, weight=st.label_weights,
                avg_factor=avg_cls)
            losses["acc"] = accuracy(cls_score, st.labels, valid=st.valid)
            num = st.rois.shape[0]
            pred_by_label = bbox_pred.reshape(num, -1, 4).gather(
                1, st.labels[:, None, None].expand(-1, 1, 4))[:, 0]
            losses["loss_bbox"] = smooth_l1_loss(
                pred_by_label, st.bbox_targets, beta=1.0,
                weight=st.bbox_weights, avg_factor=float(num))

        if self.track_head is not None:
            with _stage("track"):
                ref_roi_feats = self._roi_feats(ref_x, ref_bboxes, 7,
                                                valid=ref_valid)
                match_logits = self.track_head(bbox_feats, ref_roi_feats,
                                               ref_valid)
                id_w = st.id_weights * st.valid  # invalid rows weigh 0
                loss_match, match_acc = track_match_loss(match_logits, st.ids,
                                                         id_w)
                # the reference's normalisation: weighted-CE mean over ALL rows
                loss_match = loss_match * id_w.sum() / float(num)
                losses["loss_match"] = self.loss_match_weight * loss_match
                losses["match_acc"] = match_acc

        with _stage("mask_head"):  # on the positive prefix
            n_pos_max = st.mask_targets.shape[0]
            pos_mask = st.pos_mask[:n_pos_max]
            mask_pred = self.mask_head(self._roi_feats(
                x, st.rois[:n_pos_max], 14, valid=pos_mask))
            pred_slice = mask_pred.gather(
                1, st.labels[:n_pos_max, None, None, None]
                .expand(-1, 1, *mask_pred.shape[2:]))[:, 0]
            num_pos = pos_mask.sum().clamp(min=1)
            losses["loss_mask"] = binary_cross_entropy_with_logits(
                pred_slice, st.mask_targets,
                weight=pos_mask[:, None, None].float(),
                avg_factor=num_pos * 28.0 * 28.0)

        if tc.get("loss_pano_weight") is not None:
            with _stage("panoptic_loss"):
                losses["loss_pano"] = self._panoptic_train_loss(
                    x, fcn_score, gt_bboxes, gt_labels, gt_valid, gt_masks,
                    gt_semantic_seg_Nx) * tc["loss_pano_weight"]
        return losses

    def _panoptic_train_loss(self, x, fcn_score, gt_bboxes, gt_labels,
                             gt_valid, gt_masks, gt_semantic_seg_Nx):
        """Panoptic logits of the gt boxes (stuff logits + each instance's
        pasted mask logits plus its class's semantic logit in its box),
        MaskMatching targets and cross entropy, 255 ignored
        (panoptic_fusetrack.py:315-351, unary_logits.py:160-195)."""
        num_stuff = self.panopticFPN.num_stuff_classes
        g = gt_bboxes.shape[0]
        mask_score = self.mask_head(self._roi_feats(x, gt_bboxes, 14,
                                                    valid=gt_valid))
        labels = gt_labels.long()
        mask_score = mask_score.gather(1, labels[:, None, None, None].expand(
            -1, 1, *mask_score.shape[2:]))[:, 0]
        seg = fcn_score[0]  # (K, h, w) at 1/4
        hh, ww = seg.shape[1:]
        boxes4 = gt_bboxes * 0.25
        vals, _ = _paste_logit_window(mask_score, boxes4, (hh, ww))
        seg_win = _seg_window(boxes4, (hh, ww)) & (labels > 0)[:, None, None]
        mapped = (num_stuff - 1 + labels).clamp(0, seg.shape[0] - 1)
        term = torch.where(seg_win, seg[mapped], torch.zeros_like(vals)) + vals
        inst_logits = torch.where(gt_valid[:, None, None], term,
                                  torch.full_like(term, -1e9))
        panoptic_logits = torch.cat([seg[:num_stuff], inst_logits], 0)

        # MaskMatching: stuff from the gt seg, instance pixels -> num_stuff + i
        # (later instances overwrite), everything else 255
        gt_seg = gt_semantic_seg_Nx[0].long()
        matched = torch.where((gt_seg <= num_stuff - 1) | (gt_seg >= 255),
                              gt_seg, torch.full_like(gt_seg, -1))
        masks4 = gt_masks[:, ::4, ::4]
        inst = (masks4 != 0) & (masks4 != 255) & gt_valid[:, None, None]
        last = g - 1 - inst.flip(0).int().argmax(0)
        matched = torch.where(inst.any(0), last + num_stuff, matched)
        matched = torch.where(matched == -1, torch.full_like(matched, 255),
                              matched)
        return softmax_cross_entropy(panoptic_logits.permute(1, 2, 0)[None],
                                     matched[None], ignore_index=255)

    # ------------------------------------------------------------------
    # inference, one frame
    # ------------------------------------------------------------------

    @torch.no_grad()
    def predict(self, img, ref_img, track_state: TrackState,
                img_shape_withoutpad: Optional[Tuple[int, int]] = None,
                ref_feats=None):
        """Single-frame FuseTrack inference -> (outputs dict, new TrackState).
        ``ref_feats``: the previous frame's plain FPN pyramid (the previous
        outputs' ``fpn_feats``); None recomputes it from ref_img."""
        tcfg = self.test_cfg
        h, w = img.shape[1:3]
        x, _, plain_x = self._fused_feats(img, ref_img, ref_feats)
        with _stage("semantic_head"):
            fcn_output, _ = self.panopticFPN(
                list(x[:self.panopticFPN.num_levels]))

        with _stage("rpn"):
            cls_outs, reg_outs = self.rpn_head(x)
            anchors = self._anchors_for(cls_outs)
            rcfg = tcfg["rpn"]
            proposals, _, prop_valid = rpn_proposals(
                [c[0].permute(1, 2, 0) for c in cls_outs],
                [r[0].permute(1, 2, 0) for r in reg_outs], anchors, (h, w),
                nms_pre=rcfg.get("nms_pre", 1000),
                nms_thr=rcfg.get("nms_thr", 0.7),
                max_num=rcfg.get("max_num", 1000))

        with _stage("bbox_dets"):
            cls_score, bbox_pred = self.bbox_head(
                self._roi_feats(x, proposals, 7, valid=prop_valid))
            pano_cfg = tcfg.get("panoptic", {})
            det_boxes, det_probs, det_cls, det_valid = panoptic_dets(
                proposals, prop_valid, torch.softmax(cls_score, -1), bbox_pred,
                (h, w), score_thresh=pano_cfg.get("score_thresh", 0.6),
                nms_thresh=pano_cfg.get("nms_thresh", 0.5),
                top_n=pano_cfg.get("max_det", 100),
                reg_weights=tuple(pano_cfg.get("bbox_reg_weights",
                                               (10.0, 10.0, 5.0, 5.0))))
            det_labels = (det_cls - 1).clamp(min=0)

        det_obj_ids, new_state = self._track(x, det_boxes, det_probs,
                                             det_labels, det_valid, track_state)

        with _stage("mask_fusion"):
            mask_score = self._mask_scores(x, det_boxes, det_cls, det_valid)
            fusion = mask_removal_and_fuse(
                det_boxes, det_probs, det_cls, det_valid, det_obj_ids,
                mask_score, fcn_output[0],
                num_stuff=self.panopticFPN.num_stuff_classes)

        outputs = self._outputs(fusion, det_boxes, det_labels, det_probs,
                                det_valid, img_shape_withoutpad)
        # carry for the next frame's ref_feats
        outputs["fpn_feats"] = tuple(plain_x)
        return outputs, new_state

    def _track(self, feats, det_boxes, det_probs, det_labels, det_valid,
               track_state: TrackState):
        """Object ids of the dets and the new TrackState: the track head's
        match against the memory snapshot and the greedy assignment; without
        a track head the running count of valid dets, the state unchanged."""
        if self.track_head is None:
            ids = det_valid.long().cumsum(0) - 1
            return torch.where(det_valid, ids, torch.full_like(ids, -1)), \
                track_state
        with _stage("track"):
            det_roi_feats = self._roi_feats(feats, det_boxes, 7, valid=det_valid)
            st = track_state
            match_logprob = torch.log_softmax(
                self.track_head(det_roi_feats, st.feats, st.valid), -1)
            label_delta = (st.labels[None, :] == det_labels[:, None]).float()
            ious = bbox_overlaps(det_boxes, st.bboxes) * st.valid[None, :]
            comp = compute_comp_scores(match_logprob, det_probs[:, None], ious,
                                       label_delta, self.match_coeff)
            col_ok = torch.cat([torch.ones(1, dtype=torch.bool,
                                           device=self.device), st.valid])
            comp = torch.where(col_ok[None, :], comp,
                               torch.full_like(comp, -float("inf")))
            return track_assign(comp, det_boxes, det_labels, det_roi_feats,
                                det_valid, st)

    def _mask_scores(self, feats, boxes, det_cls, det_valid):
        """The mask head's 28x28 logits of each det's class."""
        mask_score = self.mask_head(self._roi_feats(feats, boxes, 14,
                                                    valid=det_valid))
        return mask_score.gather(1, det_cls[:, None, None, None].expand(
            -1, 1, *mask_score.shape[2:]))[:, 0]

    @staticmethod
    def _outputs(fusion, det_boxes, det_labels, det_probs, det_valid,
                 img_shape_withoutpad):
        panoptic, sseg = fusion.panoptic, fusion.sseg
        if img_shape_withoutpad is not None:
            ph, pw = img_shape_withoutpad
            panoptic, sseg = panoptic[:ph, :pw], sseg[:ph, :pw]
        return {
            "fcn_outputs": sseg,
            "panoptic_outputs": panoptic,
            "panoptic_cls_inds": fusion.keep_cls,
            "panoptic_cls_prob": fusion.keep_probs,
            "panoptic_det_obj_ids": fusion.keep_obj_ids,
            "panoptic_valid": fusion.keep_valid,
            "num_keep": fusion.num_keep,
            "det_bboxes": det_boxes,
            "det_labels": det_labels,
            "det_probs": det_probs,
            "det_valid": det_valid,
        }


DETECTORS.register(PanopticFuseTrack)


@torch.no_grad()
def predict_video(det: PanopticFuseTrack, imgs, resets, track_state: TrackState,
                  prev_img, prev_feats=None,
                  img_shape_withoutpad: Optional[Tuple[int, int]] = None):
    """Run a clip of frames through ``predict`` one frame at a time.

    imgs: (T, B, H, W, 3); resets: T bools -- frame t starts a new video
    (tracking state cleared, its reference is the frame itself, the feature
    carry recomputed). prev_img / prev_feats: last frame (and its pyramid) of
    the previous chunk; prev_feats=None computes it from prev_img. Returns
    (outputs stacked over frames without the fpn_feats carry,
    (state, feats, last_img)). A detector without a fuse neck reads no
    reference pyramid: none is computed, and the carry's feats are None; nor
    is prev_img's when the clip starts with a reset, which never reads it."""
    if prev_feats is None and det.uses_ref_feats and not bool(resets[0]):
        prev_feats = det.extract_feat(prev_img)
    state, ref_feats, prev = track_state, prev_feats, prev_img
    frames = []
    for t in range(imgs.shape[0]):
        img = imgs[t]
        if bool(resets[t]):
            state = TrackState(*(torch.zeros_like(a) for a in state))
            ref_img = img
            ref_feats = det.extract_feat(img) if det.uses_ref_feats else None
        else:
            ref_img = prev
        outputs, state = det.predict(img, ref_img, state,
                                     img_shape_withoutpad=img_shape_withoutpad,
                                     ref_feats=ref_feats)
        feats = outputs.pop("fpn_feats")
        ref_feats = feats if det.uses_ref_feats else None
        prev = img
        frames.append(outputs)
    stacked = {k: torch.stack([f[k] for f in frames]) for k in frames[0]}
    return stacked, (state, ref_feats, prev)


# the box heads' classifiers: bbox_head.fc_cls, a cascade's bbox_head.{i}.fc_cls
_CLS = r"^bbox_head\.(\d+\.)?fc_cls$"
# the single-stage heads' sigmoid classifiers, and the guided-anchoring
# heads' location convs
_SIGMOID_CLS = (r"^bbox_head\.(retina_cls|fcos_cls|reppoints_cls_out)$"
                r"|^(bbox_head|rpn_head)\.conv_loc$")


# HRNet's fuse paths: fuse_layers.<i>.<j>.1 (upsample: conv, BN) and
# fuse_layers.<i>.<j>.<s>.1 (downsample step s of i - j)
_FUSE_LAST_BN = r"fuse_layers\.(\d+)\.(\d+)\.(?:(\d+)\.)?1$"


