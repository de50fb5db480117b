"""LiteFlowNetCorr (port of vps_tpu/models/flow/liteflow.py): cost volume
(search range 4 -> 81 channels, the correlation kernel) + a 4-conv residual
flow estimator on feat + corr + init_flow. NHWC in and out, as in JAX."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from vps_torch.models.layers import Conv, leaky_relu
from vps_torch.ops import correlation


class OpticalFlowEstimatorCorr(nn.Module):
    """conv(64)+lrelu x2 -> conv(32)+lrelu -> conv(2); keys ``convs.{0,1,2}.0``
    and ``convs.3``. The flow output conv runs in f32."""

    def __init__(self, in_channels: int, dtype=None, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.convs = nn.ModuleList([
            nn.Sequential(Conv(in_channels, 64, 3, 1, 1, **kw)),
            nn.Sequential(Conv(64, 64, 3, 1, 1, **kw)),
            nn.Sequential(Conv(64, 32, 3, 1, 1, **kw)),
            Conv(32, 2, 3, 1, 1, device=device),
        ])

    def forward(self, x):
        for conv in self.convs[:3]:
            x = leaky_relu(conv(x))
        return self.convs[3](x)


class LiteFlowNetCorr(nn.Module):
    def __init__(self, in_channels: int = 256, search_range: int = 4,
                 dtype: Optional[torch.dtype] = None, device=None):
        super().__init__()
        self.search_range = search_range
        d = 2 * search_range + 1
        self.flow_estimator = OpticalFlowEstimatorCorr(
            in_channels + d * d + 2, dtype=dtype, device=device)

    def forward(self, x1, x2, flow_init):
        """x1, x2: (B, H, W, C); flow_init: (B, H, W, 2). Returns the residual
        flow (B, H, W, 2) in f32."""
        corr = correlation(x1.contiguous(), x2.contiguous(),
                           self.search_range, 1)
        x = torch.cat([x1, corr.to(x1.dtype), flow_init.to(x1.dtype)], -1)
        return self.flow_estimator(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
