"""Multilevel RoIAlign, forward (port of vps_tpu/ops/roi_align.py:
multilevel_roi_align), plain PyTorch tensor code.

Keeps the reference kernel's conventions exactly: the legacy +1 ROI end,
sample points at (i + 0.5) / sample_num inside each bin, the level map
floor(log2(sqrt(area) / 56 + 1e-6)) clipped to the levels, the kernel's
bilinear boundary rules, zero outside [-1, size]. All levels are flattened
into one (sum HW, C) table and every ROI's taps are rows of one gather.
"""

from __future__ import annotations

from typing import Sequence

import torch


def _bilinear_weights_and_indices(x, y, height, width):
    """roi_align_kernel.cu bilinear_interpolate; height/width broadcast
    per ROI. Returns (4 flat indices y * W + x, 4 weights, in-bounds)."""
    inb = (y >= -1.0) & (y <= height) & (x >= -1.0) & (x <= width)
    y = y.clamp(min=0.0)
    x = x.clamp(min=0.0)
    y_low = torch.floor(y).long()
    x_low = torch.floor(x).long()
    h1 = (height - 1).long()
    w1 = (width - 1).long()
    at_bottom = y_low >= h1
    at_right = x_low >= w1
    y_low = torch.where(at_bottom, h1, y_low)
    x_low = torch.where(at_right, w1, x_low)
    y_high = torch.where(at_bottom, h1, y_low + 1)
    x_high = torch.where(at_right, w1, x_low + 1)
    y_eff = torch.where(at_bottom, y_low.to(y.dtype), y)
    x_eff = torch.where(at_right, x_low.to(x.dtype), x)
    ly = y_eff - y_low
    lx = x_eff - x_low
    hy = 1.0 - ly
    hx = 1.0 - lx
    wint = width.long()
    idxs = (y_low * wint + x_low, y_low * wint + x_high,
            y_high * wint + x_low, y_high * wint + x_high)
    return idxs, (hy * hx, hy * lx, ly * hx, ly * lx), inb


def _nearest_weights_and_indices(x, y, height, width):
    """Nearest-pixel sampling (the fast preset), same out-of-bounds rule."""
    inb = (y >= -1.0) & (y <= height) & (x >= -1.0) & (x <= width)
    yn = torch.minimum(torch.round(y).clamp(min=0.0), height - 1).long()
    xn = torch.minimum(torch.round(x).clamp(min=0.0), width - 1).long()
    return (yn * width.long() + xn,), (torch.ones_like(x),), inb


FINEST_SCALE = 56  # mmdet SingleRoIExtractor: level 0 holds sqrt(area) < 112


def multilevel_roi_align(feats: Sequence[torch.Tensor], rois, strides,
                         out_size: int, sample_num: int = 2, valid=None,
                         sampling: str = "bilinear"):
    """feats: list of (H_l, W_l, C) for strides[l]; rois (R, 4) image
    coordinates. Returns (R, out, out, C) float32 (values gathered in the
    feature dtype, mixed in f32)."""
    dev = rois.device
    c = feats[0].shape[-1]
    r = rois.shape[0]
    sn = sample_num
    shapes = [tuple(f.shape[:2]) for f in feats]

    scale = torch.sqrt((rois[:, 2] - rois[:, 0] + 1.0)
                       * (rois[:, 3] - rois[:, 1] + 1.0))
    lvl = torch.floor(torch.log2(scale / FINEST_SCALE + 1e-6))
    lvl = lvl.clamp(0, len(shapes) - 1).long()

    hs = torch.tensor([s[0] for s in shapes], dtype=torch.float32, device=dev)
    ws = torch.tensor([s[1] for s in shapes], dtype=torch.float32, device=dev)
    sizes = [h * w for h, w in shapes]
    offsets = torch.tensor([sum(sizes[:i]) for i in range(len(sizes))],
                           dtype=torch.long, device=dev)
    scales = torch.tensor([1.0 / s for s in strides], dtype=torch.float32,
                          device=dev)
    roi_scale = scales[lvl]
    roi_h = hs[lvl][:, None]
    roi_w = ws[lvl][:, None]

    start_w = rois[:, 0] * roi_scale
    start_h = rois[:, 1] * roi_scale
    end_w = (rois[:, 2] + 1.0) * roi_scale
    end_h = (rois[:, 3] + 1.0) * roi_scale
    bin_w = (end_w - start_w).clamp(min=0.0) / out_size
    bin_h = (end_h - start_h).clamp(min=0.0) / out_size
    p = torch.arange(out_size, dtype=torch.float32, device=dev)
    i = (torch.arange(sn, dtype=torch.float32, device=dev) + 0.5) / sn
    off = (p[:, None] + i[None, :]).reshape(-1)
    ys = start_h[:, None] + bin_h[:, None] * off[None, :]
    xs = start_w[:, None] + bin_w[:, None] * off[None, :]
    m = off.numel()
    y = ys[:, :, None].expand(r, m, m).reshape(r, -1)
    x = xs[:, None, :].expand(r, m, m).reshape(r, -1)

    if sampling == "nearest":
        idxs, wgts, inb = _nearest_weights_and_indices(x, y, roi_h, roi_w)
    else:
        idxs, wgts, inb = _bilinear_weights_and_indices(x, y, roi_h, roi_w)

    flat = torch.cat([f.reshape(-1, c) for f in feats], 0)
    roi_off = offsets[lvl][:, None]
    out = 0.0
    for idx, wgt in zip(idxs, wgts):
        vals = flat.index_select(0, (idx + roi_off).reshape(-1)).reshape(r, -1, c)
        out = out + vals.float() * wgt[..., None]
    out = out * inb[..., None]
    out = out.reshape(r, out_size, sn, out_size, sn, c).mean(dim=(2, 4))
    if valid is not None:
        out = out * valid[:, None, None, None]
    return out
