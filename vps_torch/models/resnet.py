"""ResNet backbone (port of vps_tpu/models/resnet.py): mmdet ResNet, pytorch
style (stride on the 3x3 conv) or caffe style (stride on the first 1x1
conv), BatchNorm frozen, NCHW; and ``ResLayer``, one ResNet stage run over
pooled RoI windows (the C4 detectors' shared head). Parameter names are
the mmdet state_dict names (``layer1.0.conv1.weight``, ``downsample.0``...).
``frozen_stages = s`` freezes the stem and stages 1..s (requires_grad off),
which is what JAX's stop_gradient after them does to the training step."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from vps_torch.models.layers import Conv, FrozenBatchNorm, max_pool
from vps_torch.registry import BACKBONES, SHARED_HEADS

ARCH_SETTINGS = {
    18: ("basic", (2, 2, 2, 2)),
    34: ("basic", (3, 4, 6, 3)),
    50: ("bottleneck", (3, 4, 6, 3)),
    101: ("bottleneck", (3, 4, 23, 3)),
    152: ("bottleneck", (3, 8, 36, 3)),
}


def _downsample(inplanes, outplanes, stride, dtype, device):
    return nn.Sequential(
        Conv(inplanes, outplanes, 1, stride, 0, bias=False, dtype=dtype,
             device=device),
        FrozenBatchNorm(outplanes, device=device),
    )


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, inplanes, planes, stride=1, downsample=False,
                 dtype: Optional[torch.dtype] = None, device=None,
                 style: str = "pytorch"):
        super().__init__()
        kw = dict(bias=False, dtype=dtype, device=device)
        caffe = style == "caffe"
        self.conv1 = Conv(inplanes, planes, 1, stride if caffe else 1, 0, **kw)
        self.bn1 = FrozenBatchNorm(planes, device=device)
        self.conv2 = Conv(planes, planes, 3, 1 if caffe else stride, 1, **kw)
        self.bn2 = FrozenBatchNorm(planes, device=device)
        self.conv3 = Conv(planes, planes * 4, 1, 1, 0, **kw)
        self.bn3 = FrozenBatchNorm(planes * 4, device=device)
        self.downsample = (_downsample(inplanes, planes * 4, stride, dtype,
                                       device) if downsample else None)

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, inplanes, planes, stride=1, downsample=False,
                 dtype: Optional[torch.dtype] = None, device=None,
                 style: str = "pytorch"):
        super().__init__()
        kw = dict(bias=False, dtype=dtype, device=device)
        self.conv1 = Conv(inplanes, planes, 3, stride, 1, **kw)
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


def _stage(block_cls, inplanes, planes, blocks, stride, style, dtype, device):
    """One stage: ``blocks`` blocks, the first with ``stride``; returns it
    and its output channels."""
    layers = []
    for j in range(blocks):
        s = stride if j == 0 else 1
        # torch _make_layer: project only when the shape changes
        ds = j == 0 and (s != 1 or inplanes != planes * block_cls.expansion)
        layers.append(block_cls(inplanes, planes, s, ds, dtype=dtype,
                                device=device, style=style))
        inplanes = planes * block_cls.expansion
    return nn.Sequential(*layers), inplanes


@BACKBONES.register
class ResNet(nn.Module):
    """7x7/2 stem + 3x3/2 max pool + 4 stages; returns C2..C5 (NCHW).
    ``style``: 'pytorch' (stride on the 3x3 conv) or 'caffe' (on the first
    1x1 conv of a bottleneck)."""

    def __init__(self, depth: int = 50, num_stages: int = 4,
                 out_indices=(0, 1, 2, 3), frozen_stages: int = -1,
                 dtype: Optional[torch.dtype] = None, device=None,
                 style: str = "pytorch"):
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
            layer, inplanes = _stage(block_cls, inplanes, planes,
                                     stage_blocks[i], 1 if i == 0 else 2,
                                     style, dtype, device)
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
