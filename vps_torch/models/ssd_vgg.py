"""SSD's VGG-16 backbone (port of vps_tpu/models/ssd_vgg.py): VGG-16 through
conv5_3, pool5 as a 3x3 stride-1 pool, fc6 (3x3, dilation 6) and fc7 as
convs, L2Norm on conv4_3, and the extra stride-2 blocks; NCHW, mmdet's
state_dict names (``features.<torch index>``, ``extra.<i>``,
``l2_norm.weight``).

The pools run in floor mode, as vps_tpu's do (mmdet's VGG uses ceil mode):
at 300x300 the six levels are 37, 18, 9, 5, 3, 1 a side (8096 anchors, not
mmdet's 8732).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from vps_torch.models.layers import Conv, max_pool
from vps_torch.registry import BACKBONES

# VGG16's conv plan: (number of convs, channels) a block
VGG16_BLOCKS = ((2, 64), (2, 128), (3, 256), (3, 512), (3, 512))

# SSD's extra layers: (channels, kernel, stride, padding)
EXTRA_SETTING = {
    300: ((256, 1, 1, 0), (512, 3, 2, 1), (128, 1, 1, 0), (256, 3, 2, 1),
          (128, 1, 1, 0), (256, 3, 1, 0), (128, 1, 1, 0), (256, 3, 1, 0)),
    512: ((256, 1, 1, 0), (512, 3, 2, 1), (128, 1, 1, 0), (256, 3, 2, 1),
          (128, 1, 1, 0), (256, 3, 2, 1), (128, 1, 1, 0), (256, 3, 2, 1),
          (128, 1, 1, 0), (256, 4, 1, 1)),
}


def vgg_feature_index(block: int, conv: int) -> int:
    """The torch index in mmdet's ``features`` Sequential of conv{block}_{conv}
    (1-based): each conv is followed by a ReLU, each block by a pool."""
    start = sum(2 * n + 1 for n, _ in VGG16_BLOCKS[:block - 1])
    return start + 2 * (conv - 1)


FC6_INDEX, FC7_INDEX = 31, 33  # after pool5 (30); a ReLU after each


class L2Norm(nn.Module):
    """Per-location L2 normalisation over the channels, times a learnable
    per-channel weight (initialised to ``scale``); the 1e-10 sits inside the
    square root."""

    def __init__(self, channels: int, scale: float = 20.0, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.full((channels,), float(scale),
                                              device=device))

    def forward(self, x):
        norm = torch.sqrt((x * x).sum(1, keepdim=True) + 1e-10)
        return x / norm * self.weight[None, :, None, None]


@BACKBONES.register
class SSDVGG(nn.Module):
    """Returns the SSD levels: L2Norm(conv4_3), fc7, and every second extra
    layer's output (6 levels for SSD300, 7 for SSD512)."""

    def __init__(self, input_size: int = 300, out_feature_indices=(22, 34),
                 l2_norm_scale: float = 20.0, device=None):
        super().__init__()
        self.input_size = input_size
        convs = {}
        cin = 3
        for b, (n, ch) in enumerate(VGG16_BLOCKS, start=1):
            for c in range(1, n + 1):
                convs[vgg_feature_index(b, c)] = Conv(cin, ch, 3, 1, 1,
                                                      device=device)
                cin = ch
        self.features = nn.ModuleDict({str(i): m for i, m in convs.items()})
        self.features[str(FC6_INDEX)] = Conv(512, 1024, 3, 1, 6, dilation=6,
                                             device=device)
        self.features[str(FC7_INDEX)] = Conv(1024, 1024, 1, 1, 0,
                                             device=device)
        self.l2_norm = L2Norm(512, l2_norm_scale, device=device)
        extra, cin = [], 1024
        for ch, k, s, p in EXTRA_SETTING[input_size]:
            extra.append(Conv(cin, ch, k, s, p, device=device))
            cin = ch
        self.extra = nn.ModuleList(extra)
        self.out_channels = (512, 1024) + tuple(
            ch for i, (ch, *_) in enumerate(EXTRA_SETTING[input_size])
            if i % 2 == 1)

    def forward(self, x):
        outs = []
        for b, (n, _) in enumerate(VGG16_BLOCKS, start=1):
            for c in range(1, n + 1):
                x = F.relu(self.features[str(vgg_feature_index(b, c))](x))
            if b == 4:  # conv4_3, L2-normalised
                outs.append(self.l2_norm(x))
            # pool5 is SSD's 3x3 stride-1 pool
            x = max_pool(x, 2, 2, 0) if b < 5 else max_pool(x, 3, 1, 1)
        x = F.relu(self.features[str(FC6_INDEX)](x))
        x = F.relu(self.features[str(FC7_INDEX)](x))
        outs.append(x)
        for i, conv in enumerate(self.extra):
            x = F.relu(conv(x))
            if i % 2 == 1:
                outs.append(x)
        return tuple(outs)

