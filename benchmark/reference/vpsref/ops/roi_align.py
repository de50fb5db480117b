"""Multilevel RoIAlign (port of vps_tpu/ops/roi_align.py:
multilevel_roi_align and its custom VJP), plain PyTorch tensor code.

Keeps the reference kernel's conventions exactly: the legacy +1 ROI end,
sample points at (i + 0.5) / sample_num inside each bin, the level map
floor(log2(sqrt(area) / 56 + 1e-6)) clipped to the levels, the kernel's
bilinear boundary rules, zero outside [-1, size]. All levels are flattened
into one (sum HW, C) table and every ROI's taps are rows of one gather.

The backward is JAX's ``_mra_cvjp_bwd`` (the reference kernel's atomicAdd
backward): a scatter-add of the bilinear corner weights into the features
only, accumulated in f32 whatever the feature dtype; the ROIs and the
validity mask get no gradient.
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


FINEST_SCALE = 56  # mmdet SingleRoIExtractor: level 0 holds sqrt(area) < 112


def _taps(rois, shapes, strides, out_size: int, sample_num: int,
          sampling: str):
    """Gather rows into the flattened levels, corner weights and the
    in-bounds mask of every sample of every ROI."""
    dev = rois.device
    r = rois.shape[0]
    sn = sample_num
    scale = torch.sqrt((rois[:, 2] - rois[:, 0] + 1.0)
                       * (rois[:, 3] - rois[:, 1] + 1.0))
    lvl = torch.floor(torch.log2(scale / FINEST_SCALE + 1e-6))
    # an inverted box (x2 < x1 - 1, possible after a clip) has a NaN scale:
    # level 0, as JAX's float -> int conversion makes it
    lvl = torch.nan_to_num(lvl, nan=0.0).clamp(0, len(shapes) - 1).long()

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

    if sampling != "bilinear":
        raise ValueError(f"unsupported sampling {sampling!r}")
    idxs, wgts, inb = _bilinear_weights_and_indices(x, y, roi_h, roi_w)
    roi_off = offsets[lvl][:, None]
    return tuple((idx + roi_off).reshape(-1) for idx in idxs), wgts, inb


def _roi_align_forward(feats, rois, valid, strides, out_size, sample_num,
                       sampling):
    c = feats[0].shape[-1]
    r = rois.shape[0]
    sn = sample_num
    shapes = [tuple(f.shape[:2]) for f in feats]
    gidxs, wgts, inb = _taps(rois, shapes, strides, out_size, sn, sampling)
    flat = torch.cat([f.reshape(-1, c) for f in feats], 0)
    out = 0.0
    for gidx, wgt in zip(gidxs, wgts):
        vals = flat.index_select(0, gidx).reshape(r, -1, c)
        out = out + vals.float() * wgt[..., None]
    out = out * inb[..., None]
    out = out.reshape(r, out_size, sn, out_size, sn, c).mean(dim=(2, 4))
    if valid is not None:
        out = out * valid[:, None, None, None]
    return out


class _RoIAlign(torch.autograd.Function):
    """Forward: ``_roi_align_forward``. Backward: JAX's ``_mra_cvjp_bwd``,
    the features-only f32 scatter-add (taps recomputed from the ROIs)."""

    @staticmethod
    def forward(ctx, rois, valid, conf, *feats):
        ctx.save_for_backward(rois, valid)
        ctx.conf = conf
        ctx.meta = [(tuple(f.shape), f.dtype) for f in feats]
        return _roi_align_forward(feats, rois, valid, *conf)

    @staticmethod
    def backward(ctx, ct):
        rois, valid = ctx.saved_tensors
        strides, out_size, sn, sampling = ctx.conf
        shapes = [s[:2] for s, _ in ctx.meta]
        gidxs, wgts, inb = _taps(rois, shapes, strides, out_size, sn, sampling)
        r, c = rois.shape[0], ct.shape[-1]
        ct = ct.float()
        if valid is not None:
            ct = ct * valid[:, None, None, None]
        # undo the bin mean: every (sn, sn) sample of a bin gets ct / sn^2
        ct_s = (ct[:, :, None, :, None, :] / float(sn * sn)).expand(
            r, out_size, sn, out_size, sn, c).reshape(r, -1, c)
        ct_s = ct_s * inb[..., None]
        flat = ct.new_zeros((sum(h * w for h, w in shapes), c))
        for gidx, wgt in zip(gidxs, wgts):
            flat.index_add_(0, gidx, (ct_s * wgt[..., None]).reshape(-1, c))
        grads, start = [], 0
        for (shape, dt), (h, w) in zip(ctx.meta, shapes):
            grads.append(flat[start:start + h * w].reshape(shape).to(dt))
            start += h * w
        return (None, None, None, *grads)


def multilevel_roi_align(feats: Sequence[torch.Tensor], rois, strides,
                         out_size: int, sample_num: int = 2, valid=None,
                         sampling: str = "bilinear"):
    """feats: list of (H_l, W_l, C) for strides[l]; rois (R, 4) image
    coordinates. Returns (R, out, out, C) float32 (values gathered in the
    feature dtype, mixed in f32). Differentiable in the features only."""
    conf = (tuple(strides), int(out_size), int(sample_num), sampling)
    if torch.is_grad_enabled() and any(f.requires_grad for f in feats):
        return _RoIAlign.apply(rois.detach(), valid, conf, *feats)
    return _roi_align_forward(list(feats), rois, valid, *conf)
