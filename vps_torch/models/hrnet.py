"""HRNet backbone (port of vps_tpu/models/hrnet.py): a stride-4 stem, four
Bottlenecks (``layer1``), then stages of parallel branches at strides 4,
8, 16 and 32, every module ending in a full cross-resolution fusion.
NCHW, FrozenBatchNorm, mmdet's state_dict names (``transition1.1.0.0``,
``stage2.0.branches.0.0.conv1``, ``stage2.0.fuse_layers.0.1.0``, ...).
Configured by the ``extra`` dict of the mmdet configs; HRNetV2p-W32 by
default.

As in the JAX package, the fusion upsamples with a bilinear resize (mmdet
uses nearest), and ``layer1``'s first block always has a projection.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch.nn as nn
import torch.nn.functional as F

from vps_torch.models.layers import Conv, FrozenBatchNorm, resize_bilinear
from vps_torch.models.resnet import BasicBlock, Bottleneck
from vps_torch.registry import BACKBONES

HRNET_W32 = {
    "stage1": dict(num_modules=1, num_branches=1, block="BOTTLENECK",
                   num_blocks=(4,), num_channels=(64,)),
    "stage2": dict(num_modules=1, num_branches=2, block="BASIC",
                   num_blocks=(4, 4), num_channels=(32, 64)),
    "stage3": dict(num_modules=4, num_branches=3, block="BASIC",
                   num_blocks=(4, 4, 4), num_channels=(32, 64, 128)),
    "stage4": dict(num_modules=3, num_branches=4, block="BASIC",
                   num_blocks=(4, 4, 4, 4), num_channels=(32, 64, 128, 256)),
}
BLOCKS = {"BASIC": BasicBlock, "BOTTLENECK": Bottleneck}


def _conv_bn(cin, cout, k, stride, device, relu):
    layers = [Conv(cin, cout, k, stride, k // 2, bias=False, device=device),
              FrozenBatchNorm(cout, device=device)]
    if relu:
        layers.append(nn.ReLU())
    return nn.Sequential(*layers)


class HRModule(nn.Module):
    """One high-resolution module: each branch's blocks, then every output
    i the ReLU of the sum of branch i and every other branch j brought to
    its resolution (j > i: 1x1 conv, BN, bilinear upsample; j < i: i - j
    stride-2 3x3 convs with BN, ReLU between them)."""

    def __init__(self, in_channels, num_blocks, num_channels,
                 block: str = "BASIC", device=None):
        super().__init__()
        block_cls = BLOCKS[block]
        n = len(num_channels)
        out = [c * block_cls.expansion for c in num_channels]
        branches = []
        for b in range(n):
            blocks, cin = [], in_channels[b]
            for j in range(num_blocks[b]):
                blocks.append(block_cls(cin, num_channels[b], 1,
                                        j == 0 and cin != out[b],
                                        device=device))
                cin = out[b]
            branches.append(nn.Sequential(*blocks))
        self.branches = nn.ModuleList(branches)
        fuse = []
        for i in range(n):
            row = []
            for j in range(n):
                if j > i:
                    row.append(_conv_bn(out[j], out[i], 1, 1, device, False))
                elif j == i:
                    row.append(None)
                else:
                    row.append(nn.Sequential(*(
                        _conv_bn(out[j], out[i] if s == i - j - 1 else out[j],
                                 3, 2, device, s != i - j - 1)
                        for s in range(i - j))))
            fuse.append(nn.ModuleList(row))
        self.fuse_layers = nn.ModuleList(fuse)

    def forward(self, xs):
        outs = [branch(x) for branch, x in zip(self.branches, xs)]
        fused = []
        for i, row in enumerate(self.fuse_layers):
            acc = outs[i]
            for j, layer in enumerate(row):
                if j == i:
                    continue
                y = layer(outs[j])
                if j > i:
                    y = resize_bilinear(y, acc.shape[-2:])
                acc = acc + y
            fused.append(F.relu(acc))
        return fused


@BACKBONES.register
class HRNet(nn.Module):
    """Stem (two stride-2 3x3 convs), ``layer1``, then ``stage2``..``stage4``
    of ``extra``, each after its ``transition`` (a 3x3 conv where a
    branch's channels change, a stride-2 3x3 conv of the last branch for a
    new one). Returns every branch of the last stage (NCHW).
    ``frozen_stages = s`` freezes the stem, and for s >= 1 also ``layer1``
    and everything up to ``stage{s + 1}``, as JAX's stop_gradient after
    them does."""

    def __init__(self, extra: Optional[Dict[str, Any]] = None,
                 frozen_stages: int = -1, device=None):
        super().__init__()
        cfg = dict(extra) if extra else HRNET_W32
        self.conv1 = Conv(3, 64, 3, 2, 1, bias=False, device=device)
        self.bn1 = FrozenBatchNorm(64, device=device)
        self.conv2 = Conv(64, 64, 3, 2, 1, bias=False, device=device)
        self.bn2 = FrozenBatchNorm(64, device=device)
        s1 = cfg["stage1"]
        blocks, cin = [], 64
        for j in range(s1["num_blocks"][0]):
            blocks.append(Bottleneck(cin, s1["num_channels"][0], 1, j == 0,
                                     device=device))
            cin = s1["num_channels"][0] * Bottleneck.expansion
        self.layer1 = nn.Sequential(*blocks)
        chans = [cin]
        frozen = [self.conv1, self.bn1, self.conv2, self.bn2] \
            if frozen_stages >= 0 else []
        for si, key in enumerate(("stage2", "stage3", "stage4")):
            sc = cfg[key]
            mult = BLOCKS[sc["block"]].expansion
            new = [c * mult for c in sc["num_channels"]]
            trans = []
            for b, cout in enumerate(new):
                if b < len(chans):
                    trans.append(None if chans[b] == cout else
                                 _conv_bn(chans[b], cout, 3, 1, device, True))
                else:
                    trans.append(nn.Sequential(
                        _conv_bn(chans[-1], cout, 3, 2, device, True)))
            self.add_module(f"transition{si + 1}", nn.ModuleList(trans))
            self.add_module(key, nn.Sequential(*(
                HRModule(new, sc["num_blocks"], sc["num_channels"],
                         sc["block"], device)
                for _ in range(sc["num_modules"]))))
            chans = new
            if frozen_stages >= si + 1:
                frozen += ([self.layer1] if si == 0 else []) + [
                    getattr(self, f"transition{si + 1}"), getattr(self, key)]
        for m in frozen:
            m.requires_grad_(False)

    def forward(self, x):
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.relu(self.bn2(self.conv2(x)))
        xs = [self.layer1(x)]
        for si, key in enumerate(("stage2", "stage3", "stage4")):
            trans = getattr(self, f"transition{si + 1}")
            xs = [(xs[b] if t is None else t(xs[b])) if b < len(xs)
                  else t(xs[-1]) for b, t in enumerate(trans)]
            for module in getattr(self, key):
                xs = module(xs)
        return tuple(xs)
