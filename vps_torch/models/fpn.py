"""FPN neck (port of vps_tpu/models/fpn.py): mmdet 1.x FPN with the extra P6
level by stride-2 max pool (kernel 1) on P5. Outputs are float32."""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn

from vps_torch.models.layers import ConvModule, max_pool, resize_nearest
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
