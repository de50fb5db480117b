"""FCNMaskHead (port of vps_tpu/models/mask_head.py): 4 x (3x3 conv + ReLU)
-> 2x deconv + ReLU -> 1x1 conv to num_classes channels; and
``select_mask_channel``, each RoI's channel by its 1-based label."""

from __future__ import annotations

import torch.nn as nn
import torch.nn.functional as F

from vps_torch.models.layers import Conv, ConvModule, ConvTranspose2x
from vps_torch.registry import HEADS


@HEADS.register
class FCNMaskHead(nn.Module):
    def __init__(self, num_convs=4, in_channels=256, conv_out_channels=256,
                 num_classes=9, device=None):
        super().__init__()
        self.convs = nn.ModuleList(
            ConvModule(in_channels if i == 0 else conv_out_channels,
                       conv_out_channels, 3, 1, 1, device=device)
            for i in range(num_convs))
        self.upsample = ConvTranspose2x(conv_out_channels, conv_out_channels,
                                        device=device)
        self.conv_logits = Conv(conv_out_channels, num_classes, 1, 1, 0,
                                device=device)

    def forward(self, roi_feats):
        """roi_feats (R, 14, 14, C) -> mask logits (R, num_classes, 28, 28)."""
        x = roi_feats.permute(0, 3, 1, 2)
        for conv in self.convs:
            x = conv(x)
        return self.conv_logits(F.relu(self.upsample(x)))


def select_mask_channel(mask_logits, labels):
    """mask_logits (R, K, S, S), labels (R,) 1-based -> (R, S, S): each RoI's
    channel of its label (channel 0 is the background's)."""
    return mask_logits.gather(1, labels.long()[:, None, None, None].expand(
        -1, 1, *mask_logits.shape[2:]))[:, 0]
