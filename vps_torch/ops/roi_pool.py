"""RoIPool and deformable RoI pooling (port of vps_tpu/ops/roi_pool.py),
plain PyTorch as the JAX package's are XLA compositions: each bin is a
fixed grid of taps (nearest cells for ``roi_pool``, bilinear for
``deform_roi_pool``) reduced by a max or a mean; autograd gives the
backward. Feature maps are (H, W, C), RoIs (R, 4) in image coordinates,
outputs (R, out, out, C).
"""

from __future__ import annotations

import torch


def _bin_taps(start, size, out_size: int, samples: int):
    """(R, out * samples) tap positions: ``samples`` evenly spaced taps in
    each of ``out_size`` bins of ``size / out_size`` from ``start``."""
    dev = start.device
    p = torch.arange(out_size, dtype=torch.float32, device=dev)
    i = (torch.arange(samples, dtype=torch.float32, device=dev) + 0.5) / samples
    off = (p[:, None] + i[None, :]).reshape(-1)
    return start[:, None] + (size / out_size)[:, None] * off[None, :]


def roi_pool(feat, rois, spatial_scale: float, out_size: int,
             samples_per_bin: int = 4, valid=None):
    """Max over each RoI bin of a ``samples_per_bin``² grid of nearest-cell
    taps (every cell of bins up to ``samples_per_bin`` pixels). feat
    (H, W, C); rois (R, 4). Returns (R, out, out, C)."""
    h, w, c = feat.shape
    r = rois.shape[0]
    sn = samples_per_bin
    x1, y1, x2, y2 = (torch.round(rois[:, i] * spatial_scale) for i in range(4))
    roi_w = torch.clamp(x2 - x1 + 1.0, min=1.0)
    roi_h = torch.clamp(y2 - y1 + 1.0, min=1.0)
    ys = torch.floor(_bin_taps(y1, roi_h, out_size, sn)).clamp(0, h - 1).long()
    xs = torch.floor(_bin_taps(x1, roi_w, out_size, sn)).clamp(0, w - 1).long()
    n = out_size * sn
    idx = (ys[:, :, None] * w + xs[:, None, :]).reshape(-1)
    vals = feat.reshape(-1, c).index_select(0, idx).reshape(r, n, n, c)
    out = vals.reshape(r, out_size, sn, out_size, sn, c).amax(dim=(2, 4))
    if valid is not None:
        out = out * valid[:, None, None, None]
    return out


def _gather_bilinear(feat, x, y):
    """Sample feat (H, W, C) at float pixel positions x, y (any shape S),
    zeros outside. Returns (*S, C)."""
    h, w, c = feat.shape
    x0, y0 = torch.floor(x), torch.floor(y)
    wx, wy = (x - x0)[..., None], (y - y0)[..., None]
    flat = feat.reshape(-1, c)

    def sample(yi, xi):
        inb = (xi >= 0) & (xi <= w - 1) & (yi >= 0) & (yi <= h - 1)
        idx = (yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)).long()
        vals = flat.index_select(0, idx.reshape(-1)).reshape(*x.shape, c)
        return vals * inb[..., None].to(vals.dtype)

    top = sample(y0, x0) * (1 - wx) + sample(y0, x0 + 1) * wx
    bot = sample(y0 + 1, x0) * (1 - wx) + sample(y0 + 1, x0 + 1) * wx
    return top * (1 - wy) + bot * wy


def deform_roi_pool(feat, rois, offsets, spatial_scale: float, out_size: int,
                    sample_num: int = 2, gamma: float = 0.1, valid=None):
    """Modulated deformable RoI pooling: the mean of each bin's
    ``sample_num``² bilinear taps, shifted by the bin's offset times
    ``gamma`` times the RoI's size. feat (H, W, C); rois (R, 4); offsets
    (R, out, out, 2) as (dy, dx) in RoI units, or None. Returns
    (R, out, out, C)."""
    c = feat.shape[-1]
    r = rois.shape[0]
    sn = sample_num
    x1 = rois[:, 0] * spatial_scale - 0.5
    y1 = rois[:, 1] * spatial_scale - 0.5
    x2 = (rois[:, 2] + 1.0) * spatial_scale - 0.5
    y2 = (rois[:, 3] + 1.0) * spatial_scale - 0.5
    roi_w = torch.clamp(x2 - x1, min=0.1)
    roi_h = torch.clamp(y2 - y1, min=0.1)
    n = out_size * sn
    y = _bin_taps(y1, roi_h, out_size, sn)[:, :, None].expand(r, n, n)
    x = _bin_taps(x1, roi_w, out_size, sn)[:, None, :].expand(r, n, n)
    if offsets is not None:
        dy = offsets[..., 0].repeat_interleave(sn, 1).repeat_interleave(sn, 2)
        dx = offsets[..., 1].repeat_interleave(sn, 1).repeat_interleave(sn, 2)
        y = y + gamma * roi_h[:, None, None] * dy
        x = x + gamma * roi_w[:, None, None] * dx
    sampled = _gather_bilinear(feat, x, y)
    out = sampled.reshape(r, out_size, sn, out_size, sn, c).mean(dim=(2, 4))
    if valid is not None:
        out = out * valid[:, None, None, None]
    return out
