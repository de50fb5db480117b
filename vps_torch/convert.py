"""Weight bridge: the JAX package's flax variable trees -> the port's
mmdet-named state_dict (the inverse of vps_tpu/utils/convert.py's
convert_detector and convert_flownet2; this module keeps its own copy of
the layout rules).

Layout transforms (inverse of the torch -> JAX converter):
  conv    (kh, kw, I, O)            -> (O, I, kh, kw)
  deconv  (kh, kw, I, O), flipped   -> (I, O, kh, kw)
  linear  (I, O)                    -> (O, I)
  linear over ROI features, flattened (H, W, C) in JAX -> torch's (C, H, W)
  grouped deconv (kh, kw, I/G, O), flipped -> (I, O/G, kh, kw)
  FrozenBN scale/bias + batch_stats mean/var -> weight/bias/running_mean/var
  GroupNorm scale/bias              -> weight/bias

The R-CNN zoo's flax submodules are named after their attributes
(``backbone_m``, ``bbox_head_m``, ``bbox_heads_0``, ...): ``_torch_key``
maps ``<name>_m`` to mmdet's ``<name>`` and a cascade's ``<head>s_<i>`` to
``<head>.<i>`` before the rules below are read.
"""

from __future__ import annotations

import re
from typing import Any, Callable, Dict, List, Tuple

import numpy as np
import torch

ROI_HW = 7  # the bbox / track heads' first FC consumes 7x7 ROI windows


def _flatten(tree: Dict[str, Any], prefix: Tuple[str, ...] = ()):
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            yield from _flatten(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), np.asarray(v, np.float32)


def conv_w(k):
    return np.transpose(k, (3, 2, 0, 1))


def deconv_w(k):
    return np.transpose(k[::-1, ::-1], (2, 3, 0, 1))


def linear_w(k):
    return k.T


def grouped_deconv_w(k, groups):
    kh, kw, cin_g, cout = k.shape
    w = k[::-1, ::-1].reshape(kh, kw, cin_g, groups, cout // groups)
    return w.transpose(3, 2, 4, 0, 1).reshape(groups * cin_g, cout // groups,
                                              kh, kw)


def grid_deconv1_w(k):
    """Grid R-CNN's deconv1: grid_points groups of (in = out) channels."""
    return grouped_deconv_w(k, k.shape[3] // k.shape[2])


def grid_deconv2_w(k):
    """Grid R-CNN's deconv2: one output channel a group."""
    return grouped_deconv_w(k, k.shape[3])


def linear_chw_w(k):
    rows, o = k.shape
    c = rows // (ROI_HW * ROI_HW)
    return k.reshape(ROI_HW, ROI_HW, c, o).transpose(3, 2, 0, 1).reshape(o, rows)


_WB = {"kernel": "weight", "bias": "bias"}
_BN = {"scale": "weight", "bias": "bias", "mean": "running_mean",
       "var": "running_var"}
_GN = {"scale": "weight", "bias": "bias"}
_FLOW_NETS = "flownetc|flownets_1|flownets_2|flownets_d|flownetfusion"


# (pattern over the '/'-joined flax path minus its leaf, torch key template,
#  leaf-name map, kernel transform). First match wins.
RULES: List[Tuple[str, str, Dict[str, str], Callable]] = [
    (r"backbone/conv1/Conv_0", "backbone.conv1", _WB, conv_w),
    (r"backbone/bn1", "backbone.bn1", _BN, None),
    # the backbone's stages, and the C4 detectors' shared head (one stage)
    (r"(backbone|shared_head)/layer(\d+)_(\d+)/(conv\d)/Conv_0",
     "{0}.layer{1}.{2}.{3}", _WB, conv_w),
    (r"(backbone|shared_head)/layer(\d+)_(\d+)/(bn\d)", "{0}.layer{1}.{2}.{3}",
     _BN, None),
    (r"(backbone|shared_head)/layer(\d+)_(\d+)/downsample_conv/Conv_0",
     "{0}.layer{1}.{2}.downsample.0", _WB, conv_w),
    (r"(backbone|shared_head)/layer(\d+)_(\d+)/downsample_bn",
     "{0}.layer{1}.{2}.downsample.1", _BN, None),
    (r"neck/lateral(\d+)/Conv_0", "neck.lateral_convs.{0}.conv", _WB, conv_w),
    (r"neck/fpn(\d+)/Conv_0", "neck.fpn_convs.{0}.conv", _WB, conv_w),
    (r"rpn_head/(rpn_\w+)/Conv_0", "rpn_head.{0}", _WB, conv_w),
    (r"bbox_head/shared_fc0", "bbox_head.shared_fcs.0", _WB, linear_chw_w),
    (r"bbox_head/shared_fc(\d+)", "bbox_head.shared_fcs.{0}", _WB, linear_w),
    (r"bbox_head/(fc_cls|fc_reg)", "bbox_head.{0}", _WB, linear_w),
    # DoubleConvFCBBoxHead: the residual block, bottlenecks, the fc branch
    (r"bbox_head/res_conv([12])/Conv_0", "bbox_head.res_block.conv{0}.conv",
     _WB, conv_w),
    (r"bbox_head/res_bn([12])", "bbox_head.res_block.conv{0}.bn", _BN, None),
    (r"bbox_head/res_identity/Conv_0", "bbox_head.res_block.conv_identity.conv",
     _WB, conv_w),
    (r"bbox_head/res_id_bn", "bbox_head.res_block.conv_identity.bn", _BN, None),
    (r"bbox_head/conv_branch(\d+)/(conv\d)/Conv_0",
     "bbox_head.conv_branch.{0}.{1}", _WB, conv_w),
    (r"bbox_head/conv_branch(\d+)/(bn\d)", "bbox_head.conv_branch.{0}.{1}",
     _BN, None),
    (r"bbox_head/fc_branch0", "bbox_head.fc_branch.0", _WB, linear_chw_w),
    (r"bbox_head/fc_branch(\d+)", "bbox_head.fc_branch.{0}", _WB, linear_w),
    (r"track_head/fc0", "track_head.fcs.0", _WB, linear_chw_w),
    (r"track_head/fc(\d+)", "track_head.fcs.{0}", _WB, linear_w),
    (r"mask_head/conv(\d+)/Conv_0", "mask_head.convs.{0}.conv", _WB, conv_w),
    (r"mask_head/upsample", "mask_head.upsample", _WB, deconv_w),
    (r"mask_head/conv_logits/Conv_0", "mask_head.conv_logits", _WB, conv_w),
    (r"mask_head/conv_res/Conv_0/Conv_0", "mask_head.conv_res.conv", _WB,
     conv_w),  # HTCMaskHead
    (r"mask_iou_head/conv(\d+)/Conv_0", "mask_iou_head.convs.{0}", _WB, conv_w),
    (r"mask_iou_head/fc0", "mask_iou_head.fcs.0", _WB, linear_chw_w),
    (r"mask_iou_head/fc(\d+)", "mask_iou_head.fcs.{0}", _WB, linear_w),
    (r"mask_iou_head/fc_mask_iou", "mask_iou_head.fc_mask_iou", _WB, linear_w),
    (r"grid_head/conv(\d+)/Conv_0", "grid_head.convs.{0}.conv", _WB, conv_w),
    (r"grid_head/gn(\d+)", "grid_head.convs.{0}.gn", _GN, None),
    (r"grid_head/fo_trans(\d+)_(\d+)_dw/Conv_0", "grid_head.forder_trans.{0}.{1}.0",
     _WB, conv_w),
    (r"grid_head/fo_trans(\d+)_(\d+)_pw/Conv_0", "grid_head.forder_trans.{0}.{1}.1",
     _WB, conv_w),
    (r"grid_head/so_trans(\d+)_(\d+)_dw/Conv_0", "grid_head.sorder_trans.{0}.{1}.0",
     _WB, conv_w),
    (r"grid_head/so_trans(\d+)_(\d+)_pw/Conv_0", "grid_head.sorder_trans.{0}.{1}.1",
     _WB, conv_w),
    (r"grid_head/deconv1", "grid_head.deconv1", _WB, grid_deconv1_w),
    (r"grid_head/deconv2", "grid_head.deconv2", _WB, grid_deconv2_w),
    (r"grid_head/norm1", "grid_head.norm1", _GN, None),
    (r"semantic_head/lateral(\d+)/Conv_0/Conv_0",
     "semantic_head.lateral_convs.{0}.conv", _WB, conv_w),
    (r"semantic_head/conv(\d+)/Conv_0/Conv_0", "semantic_head.convs.{0}.conv",
     _WB, conv_w),
    (r"semantic_head/conv_embedding/Conv_0/Conv_0",
     "semantic_head.conv_embedding.conv", _WB, conv_w),
    (r"semantic_head/conv_logits/Conv_0", "semantic_head.conv_logits", _WB,
     conv_w),
    (r"panopticFPN/dc(\d)/conv_offset/Conv_0",
     "panopticFPN.deform_convs.0.{dc}.conv_offset", _WB, conv_w),
    (r"panopticFPN/dc(\d)", "panopticFPN.deform_convs.0.{dc}.conv",
     {"weight": "weight"}, conv_w),
    (r"panopticFPN/gn(\d)", "panopticFPN.deform_convs.0.{gn}",
     {"scale": "weight", "bias": "bias"}, None),
    (r"panopticFPN/conv_pred/Conv_0", "panopticFPN.conv_pred.conv", _WB, conv_w),
    (r"extra_neck/liteflownet/flow_estimator/c([012])/Conv_0",
     "extra_neck.liteflownet.flow_estimator.convs.{0}.0", _WB, conv_w),
    (r"extra_neck/liteflownet/flow_estimator/c3/Conv_0",
     "extra_neck.liteflownet.flow_estimator.convs.3", _WB, conv_w),
    (r"extra_neck/tcea_fusion/(\w+)/Conv_0", "extra_neck.tcea_fusion.{0}",
     _WB, conv_w),
    (r"extra_neck/refine/Conv_0/Conv_0", "extra_neck.refine.conv", _WB, conv_w),
    # refine_type='att': the conv, then CBAM (the JAX converter has no
    # names for these; the port's are its own)
    (r"extra_neck/refine_conv/Conv_0/Conv_0", "extra_neck.refine_conv.conv",
     _WB, conv_w),
    (r"extra_neck/refine_att/(mlp[01])", "extra_neck.refine_att.{0}", _WB,
     linear_w),
    (r"extra_neck/refine_att/spatial/Conv_0", "extra_neck.refine_att.spatial",
     _WB, conv_w),
    (rf"flownet2/({_FLOW_NETS})/(predict_flow\d)/Conv_0", "flownet2.{0}.{1}",
     _WB, conv_w),
    (rf"flownet2/({_FLOW_NETS})/(\w+)/Conv_0", "flownet2.{0}.{1}.0", _WB, conv_w),
    (rf"flownet2/({_FLOW_NETS})/(deconv\d)/deconv", "flownet2.{0}.{1}.0", _WB,
     deconv_w),
    (rf"flownet2/({_FLOW_NETS})/(upsampled_flow\d_to_\d)/up", "flownet2.{0}.{1}",
     _WB, deconv_w),
    (r"flownet2/(c1|c2|pred)/Conv_0", "flownet2.{0}", _WB, conv_w),  # TinyFlow
]
_COMPILED = [(re.compile(p + "$"), t, m, f) for p, t, m, f in RULES]


_ZOO_TOP = re.compile(r"(\w+?)(?:_m|s_(\d+))$")


def _torch_key(path: Tuple[str, ...]):
    stage = None
    m = _ZOO_TOP.match(path[0])
    if m:
        path = (m.group(1),) + tuple(path[1:])
        stage = m.group(2)
    key, fn = _rule_key(path)
    if stage is not None:  # a cascade's <head>.<i>.<rest>
        head, rest = key.split(".", 1)
        key = f"{head}.{stage}.{rest}"
    return key, fn


def _rule_key(path: Tuple[str, ...]):
    body, leaf = "/".join(path[:-1]), path[-1]
    for pat, tmpl, leaf_map, fn in _COMPILED:
        m = pat.match(body)
        if m and leaf in leaf_map:
            groups = m.groups()
            extra = {}
            if "{dc}" in tmpl:
                extra["dc"] = 3 * int(groups[0])
            if "{gn}" in tmpl:
                extra["gn"] = 3 * int(groups[0]) + 1
            key = tmpl.format(*groups, **extra) + "." + leaf_map[leaf]
            return key, (fn if leaf in ("kernel", "weight") else None)
    raise KeyError(f"no torch name for flax variable {'/'.join(path)}")


def state_dict_from_jax(params, batch_stats=None) -> Dict[str, torch.Tensor]:
    """flax ``params`` (and ``batch_stats``) trees of a PanopticFuseTrack,
    PanopticFuse or PanopticTrack (either fuse neck, either refine type), or
    of a two-stage or cascade R-CNN of the zoo, as numpy arrays -> the
    port's mmdet-named state_dict (float32 tensors), accepted by the same
    detector's ``load_state_dict(strict=True)``: a tower the tree lacks has
    no keys."""
    sd: Dict[str, torch.Tensor] = {}
    for tree in (params, batch_stats or {}):
        for path, value in _flatten(tree):
            key, fn = _torch_key(path)
            if fn is not None:
                value = fn(value)
            sd[key] = torch.from_numpy(np.array(value, np.float32, order="C"))
    return sd
