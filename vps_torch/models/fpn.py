"""Necks (port of vps_tpu/models/fpn.py): mmdet 1.x FPN with the extra P6
level by stride-2 max pool (kernel 1) on P5, and HRNet's HRFPN. Outputs are
float32."""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn

from vps_torch.models.layers import (
    ConvModule,
    avg_pool,
    max_pool,
    resize_bilinear,
    resize_nearest,
)
from vps_torch.registry import NECKS


@NECKS.register
class FPN(nn.Module):
    def __init__(self, in_channels: Sequence[int] = (256, 512, 1024, 2048),
                 out_channels: int = 256, num_outs: int = 5,
                 dtype: Optional[torch.dtype] = None, device=None):
        super().__init__()
        self.num_outs = num_outs
        kw = dict(relu=False, dtype=dtype, device=device)
        self.lateral_convs = nn.ModuleList(
            ConvModule(c, out_channels, 1, 1, 0, **kw) for c in in_channels)
        self.fpn_convs = nn.ModuleList(
            ConvModule(out_channels, out_channels, 3, 1, 1, **kw)
            for _ in in_channels)

    def forward(self, inputs):
        laterals = [conv(x) for conv, x in zip(self.lateral_convs, inputs)]
        for i in range(len(laterals) - 1, 0, -1):
            laterals[i - 1] = laterals[i - 1] + resize_nearest(
                laterals[i], laterals[i - 1].shape[-2:])
        outs = [conv(l).float() for conv, l in zip(self.fpn_convs, laterals)]
        for _ in range(self.num_outs - len(outs)):
            outs.append(max_pool(outs[-1], 1, 2, 0))
        return tuple(outs)


@NECKS.register
class HRFPN(nn.Module):
    """HRNet's neck: every branch upsampled (bilinear) to the first one's
    size and concatenated, a 1x1 ``reduction_conv``, a pyramid of average
    (or max) pools with kernel and stride 2^i, and a 3x3 conv a level
    (``fpn_convs.i``)."""

    def __init__(self, in_channels: Sequence[int] = (32, 64, 128, 256),
                 out_channels: int = 256, num_outs: int = 5,
                 pooling: str = "avg", device=None):
        super().__init__()
        if pooling not in ("avg", "max"):
            raise ValueError(f"HRFPN: pooling {pooling!r}")
        self.num_outs = num_outs
        self.pool = avg_pool if pooling == "avg" else max_pool
        kw = dict(relu=False, device=device)
        self.reduction_conv = ConvModule(sum(in_channels), out_channels, 1, 1,
                                         0, **kw)
        self.fpn_convs = nn.ModuleList(
            ConvModule(out_channels, out_channels, 3, 1, 1, **kw)
            for _ in range(num_outs))

    def forward(self, inputs):
        size = inputs[0].shape[-2:]
        feat = self.reduction_conv(torch.cat(
            [inputs[0]] + [resize_bilinear(x, size) for x in inputs[1:]], 1))
        pyramid = [feat] + [self.pool(feat, 2 ** i, 2 ** i, 0)
                            for i in range(1, self.num_outs)]
        return tuple(conv(p).float() for conv, p in zip(self.fpn_convs,
                                                        pyramid))
