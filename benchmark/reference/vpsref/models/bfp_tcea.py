"""BFPTcea "Fuse" extra neck (port of vps_tpu/models/bfp_tcea.py): gather
every FPN level to the refine level, warp the reference frame's gathered
feature by the initial flow, refine the residual flow with LiteFlowNetCorr,
re-warp, fuse with TCEA, refine with a 3x3 conv (``refine_type='conv'``)
and scatter the result back residually to every level. Levels are NCHW;
flows NHWC."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from reference.vpsref.models.flow.liteflow import LiteFlowNetCorr
from reference.vpsref.models.flow.tcea import TCEAFusion
from reference.vpsref.models.layers import (
    ConvModule,
    adaptive_max_pool,
    resize_nearest,
)
from reference.vpsref.ops import flow_warp


class BFPTcea(nn.Module):
    def __init__(self, in_channels: int = 256, num_levels: int = 5,
                 refine_level: int = 0, refine_type: Optional[str] = "conv",
                 nframes: int = 2, center: int = 0,
                 compute_dtype: Optional[torch.dtype] = torch.bfloat16,
                 warp_sampling: str = "bilinear", device=None):
        super().__init__()
        if refine_type not in ("conv", None):
            raise ValueError(f"unknown refine_type {refine_type!r}")
        self.num_levels = num_levels
        self.refine_level = refine_level
        self.refine_type = refine_type
        self.compute_dtype = compute_dtype
        self.warp_sampling = warp_sampling
        kw = dict(dtype=compute_dtype, device=device)
        self.liteflownet = LiteFlowNetCorr(in_channels, 4, **kw)
        self.tcea_fusion = TCEAFusion(in_channels, nframes, center, **kw)
        if refine_type == "conv":
            self.refine = ConvModule(in_channels, in_channels, 3, 1, 1, **kw)

    def gather(self, inputs):
        """Resize-and-average all levels to the refine level's size."""
        size = inputs[self.refine_level].shape[-2:]
        feats = [adaptive_max_pool(f, size) if i < self.refine_level
                 else resize_nearest(f, size) for i, f in enumerate(inputs)]
        return sum(feats) / len(feats)

    def forward(self, inputs, ref_inputs, flow_init):
        """inputs / ref_inputs: tuples of (B, C, H_l, W_l); flow_init
        (B, H0, W0, 2) at the refine level's scale. The TCEA fuses
        [cur, ref]."""
        if len(inputs) != self.num_levels:
            raise ValueError(f"expected {self.num_levels} levels, got {len(inputs)}")
        dt = self.compute_dtype or torch.float32
        bsf = self.gather(inputs).to(dt).permute(0, 2, 3, 1).contiguous()
        ref_bsf = self.gather(ref_inputs).to(dt).permute(0, 2, 3, 1)

        ws = self.warp_sampling
        warp_bsf = flow_warp(ref_bsf, flow_init, sampling=ws).to(dt)
        flow_fine = self.liteflownet(bsf, warp_bsf, flow_init)
        warp_bsf = flow_warp(warp_bsf, flow_fine, sampling=ws).to(dt)

        stack = torch.stack([bsf, warp_bsf], 1).permute(0, 1, 4, 2, 3)
        out = self.tcea_fusion(stack)
        if self.refine_type == "conv":
            out = self.refine(out)
        out = out.float()

        outs = []
        for i, f in enumerate(inputs):
            size = f.shape[-2:]
            residual = (resize_nearest(out, size) if i < self.refine_level
                        else adaptive_max_pool(out, size))
            outs.append(residual + f)
        return tuple(outs)


