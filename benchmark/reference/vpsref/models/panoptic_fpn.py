"""UPSNet-style semantic head (port of vps_tpu/models/panoptic_fpn.py): a
shared tower of 3 x (DeformConvWithOffset -> GroupNorm(32) -> ReLU) over 4
FPN levels, upsampled to 1/4 scale, concatenated, 1x1 conv to class logits.
Parameter names follow the reference (``deform_convs.0.{0,3,6}.conv_offset``,
``deform_convs.0.{0,3,6}.conv.weight``, GroupNorm at ``deform_convs.0.{1,4,7}``,
``conv_pred.conv``). Levels are NCHW; the deformable op runs NHWC."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from reference.vpsref.models.layers import Conv, ConvModule, avg_pool, resize_bilinear
from reference.vpsref.ops import deform_conv2d_multilevel


class _DeformWeight(nn.Module):
    """Holds the DCN kernel under the reference name ``conv.weight``."""

    def __init__(self, in_channels, out_channels, k, device=None):
        super().__init__()
        self.weight = nn.Parameter(
            torch.empty(out_channels, in_channels, k, k, device=device))
        nn.init.kaiming_normal_(self.weight)


class DeformConvWithOffset(nn.Module):
    """3x3 offset conv (f32) + deformable conv v1 in ``compute_dtype``; takes
    a list of levels (the shared-tower case) and returns f32 levels."""

    def __init__(self, in_channels, out_channels, kernel_size=3, padding=1,
                 compute_dtype: Optional[torch.dtype] = torch.bfloat16,
                 dcn_sampling: str = "bilinear", device=None):
        super().__init__()
        k = kernel_size
        self.padding = padding
        self.compute_dtype = compute_dtype
        self.dcn_sampling = dcn_sampling
        self.conv_offset = Conv(in_channels, k * k * 2, 3, 1, 1, device=device)
        self.conv = _DeformWeight(in_channels, out_channels, k, device=device)

    def forward(self, xs):
        dt = self.compute_dtype or torch.float32
        offsets = [self.conv_offset(x).permute(0, 2, 3, 1) for x in xs]
        xcs = [x.to(dt).permute(0, 2, 3, 1).contiguous() for x in xs]
        outs = deform_conv2d_multilevel(xcs, offsets, self.conv.weight,
                                        padding=self.padding,
                                        sampling=self.dcn_sampling)
        return [o.permute(0, 3, 1, 2) for o in outs]


class UPSNetFPN(nn.Module):
    def __init__(self, in_channels: int = 256, out_channels: int = 128,
                 num_levels: int = 4, num_things_classes: int = 8,
                 num_classes: int = 19, dcn_sampling: str = "bilinear",
                 head_stride: int = 4,
                 compute_dtype: Optional[torch.dtype] = torch.bfloat16,
                 device=None):
        super().__init__()
        if head_stride not in (4, 8):
            raise ValueError(f"head_stride {head_stride} not in (4, 8)")
        self.num_levels = num_levels
        self.num_classes = num_classes
        self.num_things_classes = num_things_classes
        self.head_stride = head_stride
        kw = dict(compute_dtype=compute_dtype, dcn_sampling=dcn_sampling,
                  device=device)
        self.deform_convs = nn.ModuleList([nn.Sequential(
            DeformConvWithOffset(in_channels, in_channels, **kw),
            nn.GroupNorm(32, in_channels, eps=1e-5, device=device),
            nn.ReLU(),
            DeformConvWithOffset(in_channels, out_channels, **kw),
            nn.GroupNorm(32, out_channels, eps=1e-5, device=device),
            nn.ReLU(),
            DeformConvWithOffset(out_channels, out_channels, **kw),
            nn.GroupNorm(32, out_channels, eps=1e-5, device=device),
            nn.ReLU(),
        )])
        self.conv_pred = ConvModule(out_channels * num_levels, num_classes, 1,
                                    1, 0, relu=False, device=device)

    @property
    def num_stuff_classes(self):
        return self.num_classes - self.num_things_classes

    def forward(self, inputs):
        """inputs: 4 FPN levels (B, C, H/4 * 2^-l, W/4 * 2^-l). Returns
        (fcn_output (B, K, H, W) full-res logits, fcn_score (B, K, H/4, W/4))."""
        if len(inputs) != self.num_levels:
            raise ValueError(f"expected {self.num_levels} levels")
        outs = list(inputs)
        if self.head_stride == 8:
            outs[0] = avg_pool(outs[0], 2, 2, 0)
        tower = self.deform_convs[0]
        for j in (0, 3, 6):
            outs = [F.relu(tower[j + 1](o)) for o in tower[j](outs)]
        h, w = outs[0].shape[-2:]
        feat = torch.cat([outs[0]] + [resize_bilinear(o, (h, w))
                                      for o in outs[1:]], 1)
        fcn_score = self.conv_pred(feat)
        if self.head_stride == 8:
            fcn_score = resize_bilinear(fcn_score, (h * 2, w * 2))
            h, w = fcn_score.shape[-2:]
        fcn_output = resize_bilinear(fcn_score, (h * 4, w * 4))
        return fcn_output, fcn_score
