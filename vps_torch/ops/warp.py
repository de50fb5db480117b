"""Dense warping ops (port of vps_tpu/ops/warp.py), NHWC at the public
functions. Flow tensors are (B, H, W, 2) with [..., 0] = x displacement and
[..., 1] = y, in pixels.

``grid_sample``'s backward on the card adds into the input's gradient with
atomics, in no fixed order, and PyTorch has no deterministic form of it.
Under ``torch.use_deterministic_algorithms`` (``train_policy``)
``flow_warp`` goes through ``grid_sample_deterministic``: the same forward
call, and a backward that gathers the four corners for the grid's gradient
and adds the input's through ``index_add_``, which that mode makes
deterministic. Outside the mode the library's backward runs."""

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
    x = x.float().permute(0, 3, 1, 2)
    if (torch.are_deterministic_algorithms_enabled()
            and torch.is_grad_enabled()
            and (x.requires_grad or grid.requires_grad)):
        out = grid_sample_deterministic(x, grid, sampling)
    else:
        out = F.grid_sample(x, grid, mode=sampling, padding_mode="zeros",
                            align_corners=False)
    return out.permute(0, 2, 3, 1)


def _corners(grid, h: int, w: int, mode: str):
    """The taps of grid_sample (zeros padding, align_corners=False) at each
    output point: [(flat index into H*W, weight, in-bounds)], and for
    bilinear the fractional offsets (tx, ty) of the point from its top-left
    corner."""
    ix = ((grid[..., 0] + 1.0) * w - 1.0) / 2.0
    iy = ((grid[..., 1] + 1.0) * h - 1.0) / 2.0
    if mode == "nearest":
        xn, yn = torch.round(ix), torch.round(iy)  # half to even, as nearbyint
        inb = (xn >= 0) & (xn <= w - 1) & (yn >= 0) & (yn <= h - 1)
        idx = (yn.clamp(0, h - 1) * w + xn.clamp(0, w - 1)).long()
        return [(idx, torch.ones_like(ix), inb)], None
    x0, y0 = torch.floor(ix), torch.floor(iy)
    tx, ty = ix - x0, iy - y0
    taps = []
    for dy, wy in ((0, 1.0 - ty), (1, ty)):
        for dx, wx in ((0, 1.0 - tx), (1, tx)):
            xc, yc = x0 + dx, y0 + dy
            inb = (xc >= 0) & (xc <= w - 1) & (yc >= 0) & (yc <= h - 1)
            idx = (yc.clamp(0, h - 1) * w + xc.clamp(0, w - 1)).long()
            taps.append((idx, wx * wy, inb))
    return taps, (tx, ty)


class _GridSampleDeterministic(torch.autograd.Function):
    """F.grid_sample (zeros padding, align_corners=False) with a backward in
    a fixed order: the input's gradient is one ``index_add_`` of every
    corner's weighted output gradient (deterministic under
    ``torch.use_deterministic_algorithms``), the grid's gradient a gather of
    the four corners per output point (no scatter)."""

    @staticmethod
    def forward(ctx, x, grid, mode):
        ctx.save_for_backward(x, grid)
        ctx.mode = mode
        return F.grid_sample(x, grid, mode=mode, padding_mode="zeros",
                             align_corners=False)

    @staticmethod
    def backward(ctx, g):
        x, grid = ctx.saved_tensors
        b, c, h, w = x.shape
        ho, wo = grid.shape[1:3]
        taps, frac = _corners(grid, h, w, ctx.mode)
        base = (torch.arange(b, device=x.device) * (h * w))[:, None, None]
        rows = g.permute(0, 2, 3, 1).reshape(-1, c)  # (B*Ho*Wo, C)
        gx = gg = None
        if ctx.needs_input_grad[0]:
            idx = torch.cat([(base + i).reshape(-1) for i, _, _ in taps])
            src = torch.cat([rows * (wt * m)[..., None].reshape(-1, 1)
                             for _, wt, m in taps])
            gx = x.new_zeros(b * h * w, c).index_add_(0, idx, src)
            gx = gx.reshape(b, h, w, c).permute(0, 3, 1, 2)
        if ctx.needs_input_grad[1]:
            if frac is None:  # nearest: piecewise constant in the grid
                gg = torch.zeros_like(grid)
            else:
                flat = x.permute(0, 2, 3, 1).reshape(-1, c)
                # g . value of each corner (0 outside the input)
                v = [(flat.index_select(0, (base + i).reshape(-1)) * rows)
                     .sum(1).reshape(b, ho, wo) * m for i, _, m in taps]
                tx, ty = frac
                dix = (v[1] - v[0]) * (1.0 - ty) + (v[3] - v[2]) * ty
                diy = (v[2] - v[0]) * (1.0 - tx) + (v[3] - v[1]) * tx
                gg = torch.stack([dix * (w / 2.0), diy * (h / 2.0)], -1)
        return gx, gg, None


def grid_sample_deterministic(x, grid, mode: str = "bilinear"):
    """F.grid_sample(x, grid, mode, padding_mode='zeros',
    align_corners=False), bit for bit, whose backward adds in a fixed order.
    x (B, C, H, W), grid (B, Ho, Wo, 2) -> (B, C, Ho, Wo)."""
    return _GridSampleDeterministic.apply(x, grid, mode)


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
