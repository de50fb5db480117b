"""ResNet backbone (port of vps_tpu/models/resnet.py): mmdet ResNet, pytorch
style (stride on the 3x3 conv) or caffe style (stride on the first 1x1
conv), BatchNorm frozen, NCHW; ``ResNeXt`` (grouped 3x3 convs); and
``ResLayer``, one ResNet stage run over pooled RoI windows (the C4
detectors' shared head). Parameter names are the mmdet state_dict names
(``layer1.0.conv1.weight``, ``downsample.0``...).
``frozen_stages = s`` freezes the stem and stages 1..s (requires_grad off),
which is what JAX's stop_gradient after them does to the training step.

The bottleneck's plugin hooks, per stage: a deformable ``conv2`` (``dcn``:
DCN v1, or modulated with ``modulated=True``, in ``deformable_groups``
groups, its offsets from the 3x3 conv ``conv2_offset``), GCNet's
``context_block`` after ``bn3`` and a ``gen_attention_block`` after
``bn2``'s ReLU. The DCN runs ``deform_conv2d_grouped``'s plain form, as
JAX's is an XLA composition; named profiler ranges ``backbone_dcn``,
``backbone_attention`` and ``backbone_gcb`` hold the plugins' work."""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from vps_torch.models.layers import Conv, FrozenBatchNorm, max_pool
from vps_torch.models.plugins import ContextBlock, GeneralizedAttention
from vps_torch.ops.deform_conv import deform_conv2d_grouped
from vps_torch.registry import BACKBONES, SHARED_HEADS

ARCH_SETTINGS = {
    18: ("basic", (2, 2, 2, 2)),
    34: ("basic", (3, 4, 6, 3)),
    50: ("bottleneck", (3, 4, 6, 3)),
    101: ("bottleneck", (3, 4, 23, 3)),
    152: ("bottleneck", (3, 8, 36, 3)),
}

_range = torch.profiler.record_function


def _downsample(inplanes, outplanes, stride, dtype, device):
    return nn.Sequential(
        Conv(inplanes, outplanes, 1, stride, 0, bias=False, dtype=dtype,
             device=device),
        FrozenBatchNorm(outplanes, device=device),
    )


class DeformConv2(nn.Module):
    """The bottleneck's deformable 3x3 conv: mmdet's ``DeformConv`` /
    ``ModulatedDeformConv`` weight (Cout, Cin, 3, 3), no bias. Takes NCHW x
    and ``conv2_offset``'s NCHW output: ``deformable_groups`` x 18 offset
    channels, then (modulated) ``deformable_groups`` x 9 mask logits."""

    def __init__(self, channels: int, stride: int, dilation: int,
                 deformable_groups: int, modulated: bool,
                 dtype: Optional[torch.dtype], device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(channels, channels, 3, 3,
                                               device=device))
        nn.init.kaiming_normal_(self.weight)
        self.stride, self.dilation = stride, dilation
        self.groups, self.modulated = deformable_groups, modulated
        self.compute_dtype = dtype

    def forward(self, x, off):
        off = off.permute(0, 2, 3, 1)
        n = self.groups * 18
        mask = torch.sigmoid(off[..., n:]) if self.modulated else None
        x, w = x.permute(0, 2, 3, 1), self.weight
        if self.compute_dtype is not None:
            x, w = x.to(self.compute_dtype), w.to(self.compute_dtype)
        with _range("backbone_dcn"):
            out = deform_conv2d_grouped(
                x, off[..., :n], w, self.groups, stride=self.stride,
                padding=self.dilation, dilation=self.dilation, mask=mask)
        return out.permute(0, 3, 1, 2)


class Bottleneck(nn.Module):
    """``groups`` > 1 makes it ResNeXt's: ``conv2`` grouped, the width
    int(planes * base_width / 64) * groups. ``dcn`` (dict: modulated,
    deformable_groups, fallback_on_stride), ``gcb`` (ContextBlock's
    arguments) and ``gen_attention`` (GeneralizedAttention's) mount the
    plugins."""

    expansion = 4

    def __init__(self, inplanes, planes, stride=1, downsample=False,
                 dtype: Optional[torch.dtype] = None, device=None,
                 style: str = "pytorch", dilation: int = 1, groups: int = 1,
                 base_width: int = 4, dcn: Optional[Dict[str, Any]] = None,
                 gcb: Optional[Dict[str, Any]] = None,
                 gen_attention: Optional[Dict[str, Any]] = None):
        super().__init__()
        kw = dict(bias=False, dtype=dtype, device=device)
        caffe = style == "caffe"
        stride2 = 1 if caffe else stride
        width = (planes if groups == 1
                 else int(planes * (base_width / 64.0)) * groups)
        if dcn is not None and dcn.get("fallback_on_stride", False) \
                and stride2 > 1:
            dcn = None
        self.conv1 = Conv(inplanes, width, 1, stride if caffe else 1, 0, **kw)
        self.bn1 = FrozenBatchNorm(width, device=device)
        if dcn is None:
            self.conv2 = Conv(width, width, 3, stride2, dilation, groups=groups,
                              dilation=dilation, **kw)
            self.conv2_offset = None
        else:
            dg = dcn.get("deformable_groups", 1)
            modulated = dcn.get("modulated", False)
            self.conv2_offset = Conv(width, dg * (27 if modulated else 18), 3,
                                     stride2, dilation, dilation=dilation,
                                     device=device)
            self.conv2 = DeformConv2(width, stride2, dilation, dg, modulated,
                                     dtype, device)
        self.bn2 = FrozenBatchNorm(width, device=device)
        self.conv3 = Conv(width, planes * 4, 1, 1, 0, **kw)
        self.bn3 = FrozenBatchNorm(planes * 4, device=device)
        self.downsample = (_downsample(inplanes, planes * 4, stride, dtype,
                                       device) if downsample else None)
        self.gen_attention_block = (
            None if gen_attention is None else
            GeneralizedAttention(width, device=device, **gen_attention))
        self.context_block = (None if gcb is None else
                              ContextBlock(planes * 4, device=device, **gcb))

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        if self.conv2_offset is None:
            out = self.conv2(out)
        else:
            out = self.conv2(out, self.conv2_offset(out))
        out = F.relu(self.bn2(out))
        if self.gen_attention_block is not None:
            with _range("backbone_attention"):
                out = self.gen_attention_block(out)
        out = self.bn3(self.conv3(out))
        if self.context_block is not None:
            with _range("backbone_gcb"):
                out = self.context_block(out)
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, inplanes, planes, stride=1, downsample=False,
                 dtype: Optional[torch.dtype] = None, device=None,
                 style: str = "pytorch", dilation: int = 1):
        super().__init__()
        kw = dict(bias=False, dtype=dtype, device=device)
        self.conv1 = Conv(inplanes, planes, 3, stride, dilation,
                          dilation=dilation, **kw)
        self.bn1 = FrozenBatchNorm(planes, device=device)
        self.conv2 = Conv(planes, planes, 3, 1, 1, **kw)
        self.bn2 = FrozenBatchNorm(planes, device=device)
        self.downsample = (_downsample(inplanes, planes, stride, dtype, device)
                           if downsample else None)

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


def _stage(block_cls, inplanes, planes, blocks, stride, style, dtype, device,
           dilation=1, block_kw=lambda j: {}):
    """One stage: ``blocks`` blocks, the first with ``stride``; block j
    takes ``block_kw(j)`` besides. Returns it and its output channels."""
    layers = []
    for j in range(blocks):
        s = stride if j == 0 else 1
        # torch _make_layer: project only when the shape changes
        ds = j == 0 and (s != 1 or inplanes != planes * block_cls.expansion)
        layers.append(block_cls(inplanes, planes, s, ds, dtype=dtype,
                                device=device, style=style, dilation=dilation,
                                **block_kw(j)))
        inplanes = planes * block_cls.expansion
    return nn.Sequential(*layers), inplanes


@BACKBONES.register
class ResNet(nn.Module):
    """7x7/2 stem + 3x3/2 max pool + ``num_stages`` stages of ``strides``
    and ``dilations``; returns the stages in ``out_indices`` (C2..C5, NCHW).
    ``style``: 'pytorch' (stride on the 3x3 conv) or 'caffe' (on the first
    1x1 conv of a bottleneck). The bottleneck options: ``groups`` and
    ``base_width`` (ResNeXt), ``dcn`` in the stages ``stage_with_dcn``,
    ``gcb`` in ``stage_with_gcb``, ``gen_attention`` on the blocks
    ``stage_with_gen_attention[i]`` of stage i."""

    def __init__(self, depth: int = 50, num_stages: int = 4,
                 out_indices=(0, 1, 2, 3), frozen_stages: int = -1,
                 dtype: Optional[torch.dtype] = None, device=None,
                 style: str = "pytorch",
                 strides: Sequence[int] = (1, 2, 2, 2),
                 dilations: Sequence[int] = (1, 1, 1, 1),
                 groups: int = 1, base_width: int = 4,
                 dcn: Optional[Dict[str, Any]] = None,
                 stage_with_dcn: Sequence[bool] = (False,) * 4,
                 gcb: Optional[Dict[str, Any]] = None,
                 stage_with_gcb: Sequence[bool] = (False,) * 4,
                 gen_attention: Optional[Dict[str, Any]] = None,
                 stage_with_gen_attention: Sequence[Sequence[int]] = ((),) * 4):
        super().__init__()
        kind, stage_blocks = ARCH_SETTINGS[depth]
        block_cls = Bottleneck if kind == "bottleneck" else BasicBlock
        self.out_indices = tuple(out_indices)
        self.num_stages = num_stages
        self.conv1 = Conv(3, 64, 7, 2, 3, bias=False, dtype=dtype,
                          device=device)
        self.bn1 = FrozenBatchNorm(64, device=device)
        inplanes, planes = 64, 64
        for i in range(num_stages):
            def block_kw(j, i=i):
                if block_cls is not Bottleneck:
                    return {}
                kw = {}
                if groups != 1:
                    kw.update(groups=groups, base_width=base_width)
                if dcn is not None and stage_with_dcn[i]:
                    kw["dcn"] = dcn
                if gcb is not None and stage_with_gcb[i]:
                    kw["gcb"] = gcb
                if gen_attention is not None \
                        and j in stage_with_gen_attention[i]:
                    kw["gen_attention"] = gen_attention
                return kw

            layer, inplanes = _stage(block_cls, inplanes, planes,
                                     stage_blocks[i], strides[i], style,
                                     dtype, device, dilations[i], block_kw)
            self.add_module(f"layer{i + 1}", layer)
            planes *= 2
        if frozen_stages >= 0:
            for m in [self.conv1, self.bn1] + [getattr(self, f"layer{i}")
                                               for i in range(1, frozen_stages + 1)]:
                m.requires_grad_(False)

    def forward(self, x):
        x = F.relu(self.bn1(self.conv1(x)))
        x = max_pool(x, 3, 2, 1)
        outs = []
        for i in range(self.num_stages):
            x = getattr(self, f"layer{i + 1}")(x)
            if i in self.out_indices:
                outs.append(x)
        return tuple(outs)


@BACKBONES.register
class ResNeXt(ResNet):
    """ResNet with grouped bottlenecks (mmdet's ResNeXt): 32 groups of
    base width 4 unless the config says otherwise."""

    def __init__(self, groups: int = 32, base_width: int = 4, **kw):
        super().__init__(groups=groups, base_width=base_width, **kw)


@SHARED_HEADS.register
class ResLayer(nn.Module):
    """ResNet stage ``stage`` (0-based; its first block with ``stride``) run
    over pooled RoI windows (mmdet's shared_heads/res_layer.py), named
    ``layer{stage + 1}`` as in the backbone. Takes and returns NHWC
    windows (R, S, S, C)."""

    def __init__(self, depth: int = 50, stage: int = 3, stride: int = 2,
                 style: str = "pytorch", device=None):
        super().__init__()
        kind, stage_blocks = ARCH_SETTINGS[depth]
        block_cls = Bottleneck if kind == "bottleneck" else BasicBlock
        planes = 64 * 2 ** stage
        inplanes = 64 * 2 ** (stage - 1) * block_cls.expansion
        self.layer_name = f"layer{stage + 1}"
        layer, _ = _stage(block_cls, inplanes, planes, stage_blocks[stage],
                          stride, style, None, device)
        self.add_module(self.layer_name, layer)

    def forward(self, x):
        y = getattr(self, self.layer_name)(x.permute(0, 3, 1, 2))
        return y.permute(0, 2, 3, 1)
