"""The VPSNet detectors (port of vps_tpu/models/detectors/panoptic.py:
PanopticFuseTrack with its loss, _panoptic_train_loss, predict, predict_aug,
predict_video and run_video_streams; PanopticFuse, without the track head;
PanopticTrack, without the flow and the fuse neck).

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

from vps_torch import resolve_device
from vps_torch.core.targets import anchor_target, proposal_target
from vps_torch.models.bbox_head import SharedFCBBoxHead
from vps_torch.models.bfp_tcea import BFPTcea, BFPTceaMulti
from vps_torch.models.detectors.panoptic_ops import (
    TrackState,
    _paste_logit_window,
    _seg_window,
    delta2bbox_upsnet,
    empty_track_state,
    mask_removal_and_fuse,
    panoptic_dets,
    panoptic_dets_from_decoded,
    track_assign,
)
from vps_torch.models.flow.flownet2 import FlowNet2, TinyFlowNet
from vps_torch.models.fpn import FPN
from vps_torch.models.layers import (
    FrozenBatchNorm,
    compute_dtype,
    resize_bilinear,
)
from vps_torch.models.mask_head import FCNMaskHead
from vps_torch.models.panoptic_fpn import UPSNetFPN
from vps_torch.models.plugins import LayerNorm
from vps_torch.models.resnet import BasicBlock, Bottleneck, ResNet
from vps_torch.models.rpn_head import RPNHead, rpn_proposals
from vps_torch.models.track_head import (
    TrackHead,
    compute_comp_scores,
    track_match_loss,
)
from vps_torch.ops.anchors import AnchorGenerator
from vps_torch.ops.box import bbox_flip, bbox_overlaps
from vps_torch.ops.losses import (
    accuracy,
    binary_cross_entropy_with_logits,
    smooth_l1_loss,
    softmax_cross_entropy,
)
from vps_torch.ops.nms import NEG_INF, nms, top_k
from vps_torch.ops.roi_align import multilevel_roi_align
from vps_torch.registry import DETECTORS

IMG_MEAN = np.asarray([123.675, 116.28, 103.53], np.float32)
IMG_STD = np.asarray([58.395, 57.12, 57.375], np.float32)


# named ranges of predict's stages, read by torch.profiler (vps_torch.profile)
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
            necks = {"BFPTcea": BFPTcea, "BFPTceaMulti": BFPTceaMulti}
            kind = extra_neck.get("type", "BFPTcea")
            if kind not in necks:
                raise ValueError(f"unknown extra_neck type {kind!r}")
            # the detector fuses 2 frames, [current, reference], whatever the
            # config's nframes: JAX's detector calls either neck without next
            # frames, and flax sizes the TCEA's convs from that input
            self.extra_neck = necks[kind](
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
            dcn_window=panoptic.get("dcn_window"),
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
            ohem_loss_fn = None
            if rc.get("sampler", {}).get("type") == "OHEMSampler":
                def ohem_loss_fn(cand, cand_valid, assign):
                    """OHEM's hard-mining forward: the bbox head over every
                    candidate with the current weights, each one's cross
                    entropy against its assigned label; no gradient."""
                    with torch.no_grad():
                        scores, _ = self.bbox_head(
                            self._roi_feats(x, cand, 7, valid=cand_valid))
                        lbl = torch.where(assign.assigned_gt_inds > 0,
                                          assign.labels.long(), 0)
                        logp = torch.log_softmax(scores, -1)
                        return -logp.gather(1, lbl[:, None])[:, 0]
            st = proposal_target(
                generator, proposals, prop_valid, gt_bboxes, gt_labels,
                gt_valid, rc, gt_pids=gt_pids, gt_masks=gt_masks,
                target_means=self.bbox_target_means,
                target_stds=self.bbox_target_stds, loss_fn=ohem_loss_fn)

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

    @torch.inference_mode()
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

    @torch.inference_mode()
    def predict_aug(self, imgs, ref_imgs, track_state: TrackState,
                    aug_metas, img_shape_withoutpad=None):
        """Test-time-augmented inference (JAX's ``predict_aug``: mmdet's
        aug-test merge, test_mixins.py aug_test_rpn / aug_test_bboxes and
        merge_augs.py, then ``predict``'s tracking and panoptic fusion).

        imgs / ref_imgs: (V, 1, H, W, 3), every variant on one canvas, its
        content in the top-left [0, h_v) x [0, w_v) (a flipped variant is
        flipped within it). aug_metas: V dicts with ``flip``, ``scale_ratio``
        (the variant's scale over variant 0's) and ``img_shape`` (h_v, w_v).
        Variant 0 is the unflipped one at ratio 1: the merged detections,
        semantic logits, tracking and panoptic outputs live in its frame.
        Per variant: semantic logits (cut to the content, unflipped, resized
        to variant 0's shape, padded back; then the mean) and RPN proposals
        mapped back; the proposals of all variants merged by NMS; the bbox
        head of each variant on the merged proposals mapped into it, its
        decoded boxes mapped back and averaged with the probabilities; the
        masks averaged as probabilities and turned back into logits.
        Returns (outputs without the fpn_feats carry, new TrackState)."""
        tcfg = self.test_cfg
        v_count = imgs.shape[0]
        if len(aug_metas) != v_count:
            raise ValueError(f"{len(aug_metas)} aug metas for {v_count} variants")
        h, w = imgs.shape[2:4]
        metas = [(bool(m.get("flip", False)), float(m.get("scale_ratio", 1.0)),
                  tuple(m.get("img_shape", (h, w)))) for m in aug_metas]
        if metas[0][0] or metas[0][1] != 1.0:
            raise ValueError("variant 0 must be unflipped at scale_ratio 1")
        h0, w0 = metas[0][2]
        rcfg = tcfg["rpn"]
        nms_thr = rcfg.get("nms_thr", 0.7)
        max_num = rcfg.get("max_num", 1000)

        feats, all_props, all_scores, all_valid = [], [], [], []
        fcn_sum = None
        for v, (flip, ratio, (hv, wv)) in enumerate(metas):
            x_v, _, _ = self._fused_feats(imgs[v], ref_imgs[v])
            feats.append(x_v)
            with _stage("semantic_head"):
                fcn_v = self.panopticFPN(
                    list(x_v[:self.panopticFPN.num_levels]))[0][0]
                if flip or (hv, wv) != (h, w):
                    fcn_v = fcn_v[:, :hv, :wv]
                    if flip:
                        fcn_v = fcn_v.flip(-1)
                    if (hv, wv) != (h0, w0):
                        fcn_v = resize_bilinear(fcn_v[None], (h0, w0))[0]
                    fcn_v = F.pad(fcn_v, (0, w - fcn_v.shape[2],
                                          0, h - fcn_v.shape[1]))
                fcn_sum = fcn_v if fcn_sum is None else fcn_sum + fcn_v
            with _stage("rpn"):
                cls_outs, reg_outs = self.rpn_head(x_v)
                props, scores, pvalid = rpn_proposals(
                    [c[0].permute(1, 2, 0) for c in cls_outs],
                    [r[0].permute(1, 2, 0) for r in reg_outs],
                    self._anchors_for(cls_outs), (hv, wv),
                    nms_pre=rcfg.get("nms_pre", 1000), nms_thr=nms_thr,
                    max_num=max_num)
            all_props.append(self._map_boxes_back(props, flip, ratio, (hv, wv)))
            all_scores.append(scores)
            all_valid.append(pvalid)
        fcn_mean = fcn_sum / v_count

        with _stage("rpn"):  # merge_aug_proposals: one NMS, the best max_num
            cat_p, cat_s, cat_v = (torch.cat(t, 0) for t in
                                   (all_props, all_scores, all_valid))
            keep = nms(cat_p, torch.where(cat_v, cat_s, torch.zeros_like(cat_s)),
                       nms_thr, valid=cat_v)
            top_s, top_i = top_k(torch.where(keep, cat_s,
                                             torch.full_like(cat_s, NEG_INF)),
                                 max_num)
            prop_valid = top_s > NEG_INF / 2
            proposals = cat_p[top_i] * prop_valid[:, None]

        pano_cfg = tcfg.get("panoptic", {})
        reg_w = tuple(pano_cfg.get("bbox_reg_weights", (10.0, 10.0, 5.0, 5.0)))
        with _stage("bbox_dets"):
            boxes_sum = probs_sum = None
            for v, (flip, ratio, hw) in enumerate(metas):
                props_v = self._map_boxes_into(proposals, flip, ratio, hw)
                cls_score, bbox_pred = self.bbox_head(
                    self._roi_feats(feats[v], props_v, 7, valid=prop_valid))
                boxes_v = self._map_boxes_back(
                    delta2bbox_upsnet(props_v, bbox_pred, reg_w, hw),
                    flip, ratio, hw)
                probs_v = torch.softmax(cls_score, -1)
                boxes_sum = boxes_v if boxes_sum is None else boxes_sum + boxes_v
                probs_sum = probs_v if probs_sum is None else probs_sum + probs_v
            det_boxes, det_probs, det_cls, det_valid = panoptic_dets_from_decoded(
                boxes_sum / v_count, probs_sum / v_count, prop_valid,
                score_thresh=pano_cfg.get("score_thresh", 0.6),
                nms_thresh=pano_cfg.get("nms_thresh", 0.5),
                top_n=pano_cfg.get("max_det", 100))
            det_labels = (det_cls - 1).clamp(min=0)

        # tracking in variant 0's frame, on its features
        det_obj_ids, new_state = self._track(feats[0], det_boxes, det_probs,
                                             det_labels, det_valid, track_state)

        with _stage("mask_fusion"):  # merge_aug_masks: mean probability
            prob_sum = None
            for v, (flip, ratio, hw) in enumerate(metas):
                prob = torch.sigmoid(self._mask_scores(
                    feats[v], self._map_boxes_into(det_boxes, flip, ratio, hw),
                    det_cls, det_valid))
                if flip:
                    prob = prob.flip(-1)
                prob_sum = prob if prob_sum is None else prob_sum + prob
            mean_prob = (prob_sum / v_count).clamp(1e-6, 1.0 - 1e-6)
            mask_logits = torch.log(mean_prob) - torch.log1p(-mean_prob)
            fusion = mask_removal_and_fuse(
                det_boxes, det_probs, det_cls, det_valid, det_obj_ids,
                mask_logits, fcn_mean,
                num_stuff=self.panopticFPN.num_stuff_classes)
        return self._outputs(fusion, det_boxes, det_labels, det_probs,
                             det_valid, img_shape_withoutpad), new_state

    @staticmethod
    def _map_boxes_back(boxes, flip: bool, ratio: float, canvas_hw):
        """mmdet's bbox_mapping_back: a variant's frame -> variant 0's
        (unflip over the variant's content shape, then / ratio)."""
        if flip:
            boxes = bbox_flip(boxes, canvas_hw)
        return boxes / ratio if ratio != 1.0 else boxes

    @staticmethod
    def _map_boxes_into(boxes, flip: bool, ratio: float, canvas_hw):
        """mmdet's bbox_mapping: variant 0's frame -> a variant's."""
        if ratio != 1.0:
            boxes = boxes * ratio
        return bbox_flip(boxes, canvas_hw) if flip else boxes


class PanopticFuse(PanopticFuseTrack):
    """Flow fusion without tracking (mmdet's panoptic_fuse.py): no track
    head unless one is given."""


class PanopticTrack(PanopticFuseTrack):
    """Tracking without flow fusion (mmdet's panoptic_track.py): no
    FlowNet2 and no fuse neck."""

    def __init__(self, *args, extra_neck=None, with_flow: bool = False,
                 **kwargs):
        super().__init__(*args, extra_neck=extra_neck, with_flow=with_flow,
                         **kwargs)


for _cls in (PanopticFuseTrack, PanopticFuse, PanopticTrack):
    DETECTORS.register(_cls)
# the detectors whose predict takes a reference frame and a TrackState
PANOPTIC_DETECTORS = ("PanopticFuseTrack", "PanopticFuse", "PanopticTrack")


@torch.inference_mode()
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


def _own_device(det: PanopticFuseTrack) -> torch.device:
    """``det``'s device, a card named by its index ("cuda" is the current
    card)."""
    if det.device.type == "cuda" and det.device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return det.device


def _replica(det: PanopticFuseTrack, device: torch.device) -> PanopticFuseTrack:
    """``det`` itself on its own device, else a copy of it on ``device``."""
    if device == _own_device(det):
        return det
    rep = copy.deepcopy(det).to(device)
    rep.device = device
    return rep


def _local_devices(det: PanopticFuseTrack):
    """Every card when ``det`` is on one (its own first), else its device."""
    own = _own_device(det)
    if own.type != "cuda":
        return [own]
    return [own] + [torch.device("cuda", i)
                    for i in range(torch.cuda.device_count()) if i != own.index]


class _VideoStream:
    """One stream of ``run_video_streams``: its detector, its CUDA stream
    (None on the CPU), the carry between its chunks, the frames of the chunk
    it is filling, its chunks sent and not yet recorded, and one worker
    thread that runs its chunks in order."""

    def __init__(self, det, device, chunk, track_cap, img_shape_withoutpad):
        self.det, self.device, self.chunk = det, device, chunk
        self.img_shape_withoutpad = img_shape_withoutpad
        self.cuda = (torch.cuda.Stream(device) if device.type == "cuda"
                     else None)
        self.track_cap = track_cap
        self.state = self.prev_img = self.prev_feats = None
        self.imgs, self.resets, self.metas = [], [], []
        self.pending = []
        self.worker = ThreadPoolExecutor(1)

    def _run(self, imgs, resets):
        """One chunk on the worker thread; its outputs on the host. Every
        tensor of the stream's carry is made on its CUDA stream, so the
        caching allocator never hands its memory to another stream while
        this one may still read it."""
        ctx = (torch.cuda.stream(self.cuda) if self.cuda is not None
               else contextlib.nullcontext())
        with ctx:
            imgs = torch.as_tensor(imgs, device=self.device)
            if self.state is None:
                self.state = empty_track_state(self.track_cap,
                                               device=self.device)
                self.prev_img = imgs[0]
            outputs, (self.state, self.prev_feats, self.prev_img) = \
                predict_video(self.det, imgs, resets, self.state,
                              self.prev_img, prev_feats=self.prev_feats,
                              img_shape_withoutpad=self.img_shape_withoutpad)
            return {k: v.cpu().numpy() for k, v in outputs.items()}

    def flush(self):
        """Send the filled chunk to the worker, padded to ``chunk`` frames
        with its last frame (a pad only ever ends a video: the stream's next
        frame is a reset)."""
        if not self.imgs:
            return
        n_real = len(self.imgs)
        imgs = self.imgs + [self.imgs[-1]] * (self.chunk - n_real)
        resets = self.resets + [False] * (self.chunk - n_real)
        self.pending.append((self.worker.submit(self._run, np.stack(imgs),
                                                resets), self.metas))
        self.imgs, self.resets, self.metas = [], [], []

    def drain(self, record):
        """Record the real frames of every chunk sent, in order."""
        for job, metas in self.pending:
            outputs = job.result()
            for t, meta in enumerate(metas):
                record({k: v[t] for k, v in outputs.items()}, meta)
        self.pending = []


def run_video_streams(det: PanopticFuseTrack, frames, chunk: int, record,
                      img_shape_withoutpad: Optional[Tuple[int, int]] = None,
                      track_cap: int = 256, n_streams: Optional[int] = None):
    """Round-robin whole videos over parallel streams (JAX's
    ``run_video_streams``, the core of ``test_vpq --chunk/--streams``).

    ``frames`` yields (img (1, H, W, 3) normalised numpy frame, is_first,
    meta). Videos go in turn to ``n_streams`` streams (default: one per
    device), spread over every card when ``det`` is on one (else they share
    ``det``'s device); a card other than ``det``'s gets a copy of it, and
    each stream has its own CUDA stream and a worker thread, so the streams'
    chunks can overlap. A stream runs ``chunk`` frames per
    ``predict_video`` call; a chunk is padded with its last frame and the
    padded outputs are dropped. As a pad only ever ends a video and a video
    starts with a reset, every frame's outputs equal the per-frame loop's
    (``make_frame_step``). ``record(outputs, meta)`` gets each real frame's
    outputs as numpy arrays (without the fpn_feats carry), on this thread,
    stream by stream and chunk by chunk within a stream: grouped by chunk and
    interleaved across streams, as JAX's, so a consumer keys them by meta."""
    devices = _local_devices(det)
    n_streams = n_streams or len(devices)
    replicas = {}
    streams = []
    for i in range(n_streams):
        dev = devices[i % len(devices)]
        if dev not in replicas:
            replicas[dev] = _replica(det, dev)
        streams.append(_VideoStream(replicas[dev], dev, chunk, track_cap,
                                    img_shape_withoutpad))
    for dev in replicas:  # the weights in place before another stream reads
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    try:
        cur, nvid = 0, 0
        for img, is_first, meta in frames:
            if is_first:
                streams[cur].flush()
                cur = nvid % n_streams
                nvid += 1
            st = streams[cur]
            st.imgs.append(np.asarray(img))
            st.resets.append(bool(is_first))
            st.metas.append(meta)
            if len(st.imgs) == chunk:
                st.flush()
            if sum(len(s.pending) for s in streams) > 2 * n_streams:
                for s in streams:
                    s.drain(record)
        for st in streams:
            st.flush()
        for st in streams:
            st.drain(record)
    finally:
        for st in streams:
            st.worker.shutdown(wait=True)


def make_frame_step(det: PanopticFuseTrack, track_cap: int = 256,
                    img_shape_withoutpad: Optional[Tuple[int, int]] = None):
    """The per-frame loop of a video stream (the JAX test_vpq tool's
    ``step_first`` / ``step``): returns ``step(img, ref_img, is_first)`` for
    one (H, W, 3) normalised numpy frame and its reference frame, which
    returns ``predict``'s outputs without the carry. A video's first frame
    clears the track state and computes the reference pyramid from ref_img;
    later frames carry the previous frame's pyramid and the track state.
    Frame for frame the same as ``predict_video``."""
    carry = {"state": empty_track_state(track_cap, device=det.device),
             "feats": None}

    def step(img, ref_img, is_first: bool):
        if is_first:
            carry["state"] = empty_track_state(track_cap, device=det.device)
            carry["feats"] = None
        outputs, carry["state"] = det.predict(
            torch.as_tensor(img, device=det.device)[None],
            torch.as_tensor(ref_img, device=det.device)[None], carry["state"],
            img_shape_withoutpad=img_shape_withoutpad,
            ref_feats=carry["feats"])
        feats = outputs.pop("fpn_feats")
        carry["feats"] = feats if det.uses_ref_feats else None
        return outputs

    return step


# the box heads' classifiers: bbox_head.fc_cls, a cascade's bbox_head.{i}.fc_cls
_CLS = r"^bbox_head\.(\d+\.)?fc_cls$"
# the single-stage heads' sigmoid classifiers
_SIGMOID_CLS = r"^bbox_head\.(retina_cls|fcos_cls|reppoints_cls_out)$"


# HRNet's fuse paths: fuse_layers.<i>.<j>.1 (upsample: conv, BN) and
# fuse_layers.<i>.<j>.<s>.1 (downsample step s of i - j)
_FUSE_LAST_BN = r"fuse_layers\.(\d+)\.(\d+)\.(?:(\d+)\.)?1$"


def _fuse_last(name: str) -> bool:
    """An HRNet fuse path's last BN: the upsample's, or the last of the
    i - j downsample steps."""
    i, j, step = re.search(_FUSE_LAST_BN, name).groups()
    return step is None or int(step) == int(i) - int(j) - 1


def random_init_(det: nn.Module, seed: int = 0) -> nn.Module:
    """Seeded random weights that keep activations O(1) through the whole
    chain and give the detection heads a usable population: weights
    N(0, gain^2 / fan_in) (fan-in scaling as in the JAX parity tests, gain
    1.4, 1.0 for the linear FPN convs and classifiers), small biases, BN/GN affine near identity, the last BN of each
    residual branch x0.2 (so the residual sums do not double the variance
    block after block; each block's own, and each HRNet fuse path's
    last), small DCN offsets (the backbone's ``conv2_offset`` too), the
    attention's ``gamma`` 0.5 and the ContextBlock's last conv at gain 0.2
    (both zero at init, which would make the blocks identities), and a
    wide classifier so some proposals clear the 0.6 panoptic score
    threshold (and, for the R-CNN zoo's detectors, their 81-way softmax's
    0.05; every box head's ``fc_cls``, a cascade's included). The single-stage heads' sigmoid
    classifiers get the focal-loss prior bias -log(99) (their own init), an
    L2Norm or a FCOS scale stays near its initial value and RepPoints'
    moment transfer near 0. Any of the port's detectors."""
    gen = torch.Generator().manual_seed(seed)
    norms = {n for n, m in det.named_modules()
             if isinstance(m, (FrozenBatchNorm, nn.GroupNorm, LayerNorm))}
    layer1 = getattr(det.backbone, "layer1", None)  # SSD's VGG has none
    last_bn = ("bn3" if layer1 is not None and isinstance(layer1[0],
                                                          Bottleneck)
               else "bn2")
    # each residual block's own last BN (HRNet mixes both kinds), and the
    # last BN of each HRNet fuse path, whose sums add up to 4 branches
    residual = {f"backbone.{n}.{'bn3' if isinstance(m, Bottleneck) else 'bn2'}"
                for n, m in det.backbone.named_modules()
                if isinstance(m, (Bottleneck, BasicBlock))}
    residual |= {n for n in norms if re.search(_FUSE_LAST_BN, n)
                 and _fuse_last(n)}
    transposed = {n for n, m in det.named_modules()
                  if isinstance(m, nn.ConvTranspose2d)}
    # (pattern over the module name, gain); linear maps with no ReLU after
    # them keep the variance at gain 1.0
    gains = [(r"conv2?_offset$", 0.3), (_CLS, 4.0),
             (r"context_block\.channel_(add|mul)_conv\.3$", 0.2),
             (r"(fc|rpn|retina|fcos)_reg$|reppoints_pts_\w+_out$"
              r"|^bbox_head\.reg_convs\.\d+$", 0.4),
             (r"^neck\.|rpn_cls$|conv_pred\.conv$", 1.0)]
    with torch.no_grad():
        for name, p in det.state_dict().items():
            module, leaf = name.rsplit(".", 1)
            z = torch.randn(p.shape, generator=gen)
            if leaf in ("scale", "moment_transfer") or module.endswith(
                    "l2_norm"):  # near the initial value (1, 0, 20)
                init = p.detach().cpu()
                val = (init + 0.02 * z if leaf == "moment_transfer"
                       else init * (1.0 + 0.1 * z))
            elif leaf == "bias" and re.search(_SIGMOID_CLS, module):
                val = -np.log((1 - 0.01) / 0.01) + 0.02 * z
            elif leaf == "running_mean":
                val = 0.1 * z
            elif leaf == "running_var":
                val = 1.0 + 0.1 * z.abs()
            elif module in norms:
                val = 1.0 + 0.1 * z if leaf == "weight" else 0.1 * z
                if leaf == "weight" and (module.endswith("." + last_bn)
                                         or module in residual):
                    val = val * 0.2
            elif leaf == "gamma":  # the attention's residual gate (0 at init)
                val = 0.5 * (1.0 + 0.1 * z)
            elif leaf in ("appr_bias", "geom_bias"):
                val = 0.1 * z
            elif leaf == "bias":
                val = z * (1.0 if re.search(_CLS, module) else 0.02)
            else:
                fan_in = p[0].numel()
                if module in transposed:  # (in, out, kh, kw)
                    fan_in = p.shape[0] * p[0, 0].numel()
                gain = next((g for pat, g in gains if re.search(pat, module)),
                            1.4)
                val = z * (gain / np.sqrt(fan_in))
            p.copy_(val.to(p.dtype))
    return det
