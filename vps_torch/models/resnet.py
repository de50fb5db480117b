"""ResNet backbone (port of vps_tpu/models/resnet.py): mmdet ResNet, pytorch
style (stride on the 3x3 conv), BatchNorm frozen, NCHW. Parameter names are
the mmdet state_dict names (``layer1.0.conv1.weight``, ``downsample.0``...).
``frozen_stages = s`` freezes the stem and stages 1..s (requires_grad off),
which is what JAX's stop_gradient after them does to the training step."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from vps_torch.models.layers import Conv, FrozenBatchNorm, max_pool

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
                 dtype: Optional[torch.dtype] = None, device=None):
        super().__init__()
        kw = dict(bias=False, dtype=dtype, device=device)
        self.conv1 = Conv(inplanes, planes, 1, 1, 0, **kw)
        self.bn1 = FrozenBatchNorm(planes, device=device)
        self.conv2 = Conv(planes, planes, 3, stride, 1, **kw)
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
                 dtype: Optional[torch.dtype] = None, device=None):
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


class ResNet(nn.Module):
    """7x7/2 stem + 3x3/2 max pool + 4 stages; returns C2..C5 (NCHW)."""

    def __init__(self, depth: int = 50, num_stages: int = 4,
                 out_indices=(0, 1, 2, 3), frozen_stages: int = -1,
                 dtype: Optional[torch.dtype] = None, device=None):
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
            stride = 1 if i == 0 else 2
            blocks = []
            for j in range(stage_blocks[i]):
                s = stride if j == 0 else 1
                # torch _make_layer: project only when the shape changes
                ds = j == 0 and (s != 1 or inplanes != planes * block_cls.expansion)
                blocks.append(block_cls(inplanes, planes, s, ds, dtype=dtype,
                                        device=device))
                inplanes = planes * block_cls.expansion
            self.add_module(f"layer{i + 1}", nn.Sequential(*blocks))
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
