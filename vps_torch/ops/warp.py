"""Dense warping ops (port of vps_tpu/ops/warp.py), NHWC at the public
functions. Flow tensors are (B, H, W, 2) with [..., 0] = x displacement and
[..., 1] = y, in pixels."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def flow_warp(x, flow, sampling: str = "bilinear"):
    """The reference WarpingLayer: a linspace(-1, 1) base grid plus flow
    normalised by (size-1)/2, sampled with grid_sample's torch-1.4 defaults
    (zeros padding, align_corners=False) -- the reference's quirk, kept.
    x (B, H, W, C), flow (B, H, W, 2) -> (B, H, W, C) in f32 (gathered
    values mixed with f32 weights, as the JAX op promotes)."""
    b, h, w, _ = x.shape
    base_x = torch.linspace(-1.0, 1.0, w, device=x.device)[None, None, :]
    base_y = torch.linspace(-1.0, 1.0, h, device=x.device)[None, :, None]
    flow = flow.float()
    gx = base_x + flow[..., 0] / ((w - 1.0) / 2.0)
    gy = base_y + flow[..., 1] / ((h - 1.0) / 2.0)
    grid = torch.stack([gx, gy], dim=-1)
    out = F.grid_sample(x.float().permute(0, 3, 1, 2), grid, mode=sampling,
                        padding_mode="zeros", align_corners=False)
    return out.permute(0, 2, 3, 1)


def resample2d(x, flow):
    """FlowNet2's Resample2d: sample x at (pix + flow), bilinear, border
    clamp. x (B, H, W, C), flow (B, H, W, 2)."""
    b, h, w, c = x.shape
    xs = torch.arange(w, dtype=flow.dtype, device=x.device)[None, None, :] + flow[..., 0]
    ys = torch.arange(h, dtype=flow.dtype, device=x.device)[None, :, None] + flow[..., 1]
    xs = xs.clamp(0, w - 1)
    ys = ys.clamp(0, h - 1)
    x0 = xs.floor()
    y0 = ys.floor()
    wx = (xs - x0)[..., None]
    wy = (ys - y0)[..., None]
    x0i = x0.long()
    y0i = y0.long()
    x1i = (x0i + 1).clamp(max=w - 1)
    y1i = (y0i + 1).clamp(max=h - 1)
    flat = x.reshape(b, h * w, c)

    def tap(yi, xi):
        idx = (yi * w + xi).reshape(b, -1, 1).expand(-1, -1, c)
        return torch.gather(flat, 1, idx).reshape(b, h, w, c)

    top = tap(y0i, x0i) * (1 - wx) + tap(y0i, x1i) * wx
    bot = tap(y1i, x0i) * (1 - wx) + tap(y1i, x1i) * wx
    return top * (1 - wy) + bot * wy


def channel_norm(x, p: float = 2.0):
    """L_p norm across channels -> (B, H, W, 1) (the ChannelNorm op)."""
    if p == 2.0:
        return torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True))
    return torch.sum(x.abs() ** p, dim=-1, keepdim=True) ** (1.0 / p)
