"""Model-config presets of the VPSNet-FuseTrack R-50 (the port's own copy of
the JAX package's zoo: same dicts, same preset semantics)."""

from __future__ import annotations

import copy
from typing import Any, Dict


def fusetrack_model_cfg(depth: int = 50) -> Dict[str, Any]:
    return dict(
        type="PanopticFuseTrack",
        backbone=dict(type="ResNet", depth=depth, num_stages=4,
                      out_indices=(0, 1, 2, 3), frozen_stages=1,
                      style="pytorch", compute_dtype="bfloat16"),
        neck=dict(type="FPN", in_channels=[256, 512, 1024, 2048],
                  out_channels=256, num_outs=5),
        extra_neck=dict(type="BFPTcea", in_channels=256, num_levels=5,
                        refine_level=0, refine_type="conv", center=0, nframes=2),
        panoptic=dict(type="UPSNetFPN", in_channels=256, out_channels=128,
                      num_levels=4, num_things_classes=8, num_classes=19,
                      ignore_label=255, loss_weight=1.0),
        rpn_head=dict(type="RPNHead", in_channels=256, feat_channels=256,
                      anchor_scales=[8], anchor_ratios=[0.5, 1.0, 2.0],
                      anchor_strides=[4, 8, 16, 32, 64],
                      target_means=[0.0] * 4, target_stds=[1.0] * 4),
        bbox_roi_extractor=dict(type="SingleRoIExtractor",
                                roi_layer=dict(type="RoIAlign", out_size=7,
                                               sample_num=2),
                                out_channels=256, featmap_strides=[4, 8, 16, 32]),
        bbox_head=dict(type="SharedFCBBoxHead", num_fcs=2, in_channels=256,
                       fc_out_channels=1024, roi_feat_size=7, num_classes=9,
                       target_means=[0.0] * 4,
                       target_stds=[0.1, 0.1, 0.2, 0.2],
                       reg_class_agnostic=False),
        track_head=dict(type="TrackHead", num_fcs=2, in_channels=256,
                        fc_out_channels=1024, roi_feat_size=7,
                        match_coeff=[1.0, 2.0, 10.0],
                        loss_match=dict(type="CrossEntropyLoss",
                                        use_sigmoid=False, loss_weight=0.5)),
        mask_roi_extractor=dict(type="SingleRoIExtractor",
                                roi_layer=dict(type="RoIAlign", out_size=14,
                                               sample_num=2),
                                out_channels=256, featmap_strides=[4, 8, 16, 32]),
        mask_head=dict(type="FCNMaskHead", num_convs=4, in_channels=256,
                       conv_out_channels=256, num_classes=9,
                       loss_mask=dict(type="CrossEntropyLoss", use_mask=True,
                                      loss_weight=1.0)),
    )


def fusetrack_train_cfg() -> Dict[str, Any]:
    return dict(
        rpn=dict(
            assigner=dict(type="MaxIoUAssigner", pos_iou_thr=0.7,
                          neg_iou_thr=0.3, min_pos_iou=0.3, ignore_iof_thr=-1),
            sampler=dict(type="RandomSampler", num=256, pos_fraction=0.5,
                         neg_pos_ub=-1, add_gt_as_proposals=False),
            allowed_border=0, pos_weight=-1,
        ),
        rpn_proposal=dict(nms_across_levels=False, nms_pre=2000, nms_post=2000,
                          max_num=2000, nms_thr=0.7, min_bbox_size=0),
        rcnn=dict(
            assigner=dict(type="MaxIoUAssigner", pos_iou_thr=0.5,
                          neg_iou_thr=0.5, min_pos_iou=0.5, ignore_iof_thr=-1),
            sampler=dict(type="RandomSampler", num=512, pos_fraction=0.25,
                         neg_pos_ub=-1, add_gt_as_proposals=True),
            mask_size=28, pos_weight=-1,
        ),
        loss_pano_weight=0.5,
    )


def fusetrack_test_cfg() -> Dict[str, Any]:
    return dict(
        rpn=dict(nms_across_levels=False, nms_pre=1000, nms_post=1000,
                 max_num=1000, nms_thr=0.7, min_bbox_size=0),
        rcnn=dict(score_thr=0.05, nms=dict(type="nms", iou_thr=0.5),
                  max_per_img=100, mask_thr_binary=0.5),
        panoptic=dict(score_thresh=0.6, nms_thresh=0.5, max_det=100,
                      bbox_reg_weights=(10.0, 10.0, 5.0, 5.0),
                      stuff_area_limit=2048),
        loss_pano_weight=None,
    )


def exact_overrides(cfg):
    """Reference-exact preset: FlowNet2 on full-res frames and f32 compute
    everywhere. The shipped default ('half-flow') keeps half-res flow input
    and bf16 conv stacks."""
    cfg = copy.deepcopy(cfg)
    cfg["flow_input_scale"] = 1.0
    cfg["backbone"]["compute_dtype"] = "float32"
    if cfg.get("bbox_roi_extractor"):
        cfg["bbox_roi_extractor"]["compute_dtype"] = "float32"
    if cfg.get("extra_neck"):
        cfg["extra_neck"]["compute_dtype"] = "float32"
    if cfg.get("panoptic"):
        cfg["panoptic"]["compute_dtype"] = "float32"
    cfg["flow"] = dict(cfg.get("flow") or {}, compute_dtype="float32")
    return cfg


def f32_compute_overrides(cfg):
    """f32 activation compute in every tower with a compute_dtype knob,
    every other knob (flow resolution, sampling modes) as it is: the
    training default, as in the JAX trainer (parameters are f32 either
    way, so checkpoints serve every inference preset)."""
    cfg = copy.deepcopy(cfg)
    for key in ("backbone", "bbox_roi_extractor", "mask_roi_extractor",
                "extra_neck", "panoptic"):
        if cfg.get(key):
            cfg[key] = dict(cfg[key], compute_dtype="float32")
    cfg["flow"] = dict(cfg.get("flow") or {}, compute_dtype="float32")
    return cfg


def fast_overrides(cfg):
    """Speed/accuracy trade-off preset: nearest DCN and warp sampling,
    1x1 in-bin RoIAlign sampling, quarter-res FlowNet2 input."""
    cfg = copy.deepcopy(cfg)
    cfg["panoptic"]["dcn_sampling"] = "nearest"
    cfg["bbox_roi_extractor"]["roi_layer"]["sample_num"] = 1
    if cfg.get("mask_roi_extractor"):
        cfg["mask_roi_extractor"]["roi_layer"]["sample_num"] = 1
    cfg["flow_input_scale"] = 0.25
    if cfg.get("extra_neck"):
        cfg["extra_neck"]["warp_sampling"] = "nearest"
    return cfg


def lowres_sem_overrides(cfg):
    """The UPSNet semantic tower runs from stride 8 instead of 4."""
    cfg = copy.deepcopy(cfg)
    cfg["panoptic"]["head_stride"] = 8
    return cfg


PRESETS = ("exact", "half-flow", "lowres-sem", "fast", "fast-lowres")


def preset_overrides(cfg: Dict[str, Any], preset: str) -> Dict[str, Any]:
    """Apply a named inference preset ('half-flow' is the shipped default
    and leaves the config as it is)."""
    if preset == "exact":
        return exact_overrides(cfg)
    if preset in ("half-flow", "default"):
        return copy.deepcopy(cfg)
    if preset == "lowres-sem":
        return lowres_sem_overrides(cfg)
    if preset == "fast":
        return fast_overrides(cfg)
    if preset == "fast-lowres":
        return lowres_sem_overrides(fast_overrides(cfg))
    raise ValueError(f"unknown preset {preset!r}; known: {PRESETS}")


def tiny_overrides(cfg: Dict[str, Any]) -> Dict[str, Any]:
    """Shrink a model cfg for tests: ResNet-18 trunk and TinyFlow."""
    cfg = copy.deepcopy(cfg)
    cfg["backbone"]["depth"] = 18
    cfg["neck"]["in_channels"] = [64, 128, 256, 512]
    cfg["flow"] = dict(type="TinyFlow")
    return cfg


def tiny_train_cfg() -> Dict[str, Any]:
    """``fusetrack_train_cfg`` with the samplers and proposals cut for
    tests."""
    cfg = fusetrack_train_cfg()
    cfg["rpn"]["sampler"]["num"] = 64
    cfg["rpn_proposal"].update(nms_pre=200, nms_post=200, max_num=128)
    cfg["rcnn"]["sampler"]["num"] = 64
    return cfg


def tiny_test_cfg() -> Dict[str, Any]:
    """``fusetrack_test_cfg`` with the proposals and detections cut for
    tests."""
    cfg = fusetrack_test_cfg()
    cfg["rpn"].update(nms_pre=128, nms_post=128, max_num=128)
    cfg["panoptic"]["max_det"] = 16
    return cfg
