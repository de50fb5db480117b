"""BFPTcea "Fuse" extra neck (port of vps_tpu/models/bfp_tcea.py: CBAM,
BFPTcea, BFPTceaMulti): gather every FPN level to the refine level, warp the
reference frame's gathered feature by the initial flow, refine the residual
flow with LiteFlowNetCorr, re-warp, fuse with TCEA, refine with a 3x3 conv
(``refine_type='conv'``) or a 3x3 conv and CBAM (``'att'``) and scatter the
result back residually to every level. BFPTceaMulti fuses a third frame
(the next one) when it is given. Levels are NCHW; flows NHWC."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from vps_torch.models.flow.liteflow import LiteFlowNetCorr
from vps_torch.models.flow.tcea import TCEAFusion
from vps_torch.models.layers import (
    Conv,
    ConvModule,
    adaptive_max_pool,
    resize_nearest,
)
from vps_torch.ops import flow_warp


class CBAM(nn.Module):
    """Channel then spatial attention (mmdet's CBAM, as the JAX module
    computes it): a shared two-layer MLP over the global average and max of
    each channel, then a 7x7 conv over the channel mean and max. Its
    parameters compute in f32 (flax promotes the input against them), so
    the output is f32; the pooled statistics keep the input's dtype, as
    jnp.mean and jnp.max do."""

    def __init__(self, features: int, reduction: int = 16, device=None):
        super().__init__()
        self.mlp0 = nn.Linear(features, features // reduction, device=device)
        self.mlp1 = nn.Linear(features // reduction, features, device=device)
        self.spatial = Conv(2, 1, 7, 1, 3, device=device)

    def forward(self, x):
        """x (B, C, H, W) -> (B, C, H, W) f32."""
        def chan(v):
            return self.mlp1(F.relu(self.mlp0(v.float())))

        avg = chan(x.float().mean((2, 3)).to(x.dtype))
        mx = chan(x.amax((2, 3)))
        x = x.float() * torch.sigmoid(avg + mx)[:, :, None, None]
        stats = torch.cat([x.mean(1, keepdim=True), x.amax(1, keepdim=True)], 1)
        return x * torch.sigmoid(self.spatial(stats))


class BFPTcea(nn.Module):
    def __init__(self, in_channels: int = 256, num_levels: int = 5,
                 refine_level: int = 0, refine_type: Optional[str] = "conv",
                 nframes: int = 2, center: int = 0,
                 compute_dtype: Optional[torch.dtype] = torch.bfloat16,
                 warp_sampling: str = "bilinear", device=None):
        super().__init__()
        if refine_type not in ("conv", "att", None):
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
        elif refine_type == "att":
            self.refine_conv = ConvModule(in_channels, in_channels, 3, 1, 1, **kw)
            self.refine_att = CBAM(in_channels, device=device)

    def gather(self, inputs):
        """Resize-and-average all levels to the refine level's size."""
        size = inputs[self.refine_level].shape[-2:]
        feats = [adaptive_max_pool(f, size) if i < self.refine_level
                 else resize_nearest(f, size) for i, f in enumerate(inputs)]
        return sum(feats) / len(feats)

    def forward(self, inputs, ref_inputs, flow_init, next_inputs=None,
                next_flow_init=None):
        """inputs / ref_inputs (/ next_inputs): tuples of (B, C, H_l, W_l);
        flow_init (/ next_flow_init) (B, H0, W0, 2) at the refine level's
        scale. With next_inputs the TCEA fuses [ref, cur, next] (it must be
        built for 3 frames), else [cur, ref]."""
        if len(inputs) != self.num_levels:
            raise ValueError(f"expected {self.num_levels} levels, got {len(inputs)}")
        dt = self.compute_dtype or torch.float32
        bsf = self.gather(inputs).to(dt).permute(0, 2, 3, 1).contiguous()
        ref_bsf = self.gather(ref_inputs).to(dt).permute(0, 2, 3, 1)

        ws = self.warp_sampling
        warp_bsf = flow_warp(ref_bsf, flow_init, sampling=ws).to(dt)
        flow_fine = self.liteflownet(bsf, warp_bsf, flow_init)
        warp_bsf = flow_warp(warp_bsf, flow_fine, sampling=ws).to(dt)

        if next_inputs is not None:
            next_bsf = self.gather(next_inputs).to(dt).permute(0, 2, 3, 1)
            next_warp = flow_warp(next_bsf, next_flow_init, sampling=ws).to(dt)
            next_fine = self.liteflownet(bsf, next_warp, next_flow_init)
            next_warp = flow_warp(next_warp, next_fine, sampling=ws).to(dt)
            frames = [warp_bsf, bsf, next_warp]
        else:
            frames = [bsf, warp_bsf]
        stack = torch.stack(frames, 1).permute(0, 1, 4, 2, 3)
        out = self.tcea_fusion(stack)
        if self.refine_type == "conv":
            out = self.refine(out)
        elif self.refine_type == "att":
            out = self.refine_att(self.refine_conv(out))
        out = out.float()

        outs = []
        for i, f in enumerate(inputs):
            size = f.shape[-2:]
            residual = (resize_nearest(out, size) if i < self.refine_level
                        else adaptive_max_pool(out, size))
            outs.append(residual + f)
        return tuple(outs)


class BFPTceaMulti(BFPTcea):
    """The 3-frame variant (mmdet's bfp_tcea_multi.py): the same wiring,
    previous and next frame both warped onto the current one and fused,
    the current frame at the centre."""

    def __init__(self, *args, nframes: int = 3, center: int = 1, **kwargs):
        super().__init__(*args, nframes=nframes, center=center, **kwargs)
