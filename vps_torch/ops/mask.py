"""Mask cropping for training targets and mask pasting for inference (port
of vps_tpu/ops/mask.py: ``crop_and_resize_indexed``, ``_bilinear_2d`` and
``paste_masks``), plain PyTorch: one flat gather per corner, never
materialising the gathered (R, H, W) stack."""

from __future__ import annotations

import torch


def _mix4(flat, base, w, y0, x0, y1, x1, wy, wx):
    """Bilinear mix of the four corners (y0|y1, x0|x1) of flat[base + ...],
    in the JAX operation order."""
    def g4(yi, xi):
        return flat[base + yi.long() * w + xi.long()]

    top = g4(y0, x0) * (1 - wx) + g4(y0, x1) * wx
    bot = g4(y1, x0) * (1 - wx) + g4(y1, x1) * wx
    return top * (1 - wy) + bot * wy


def _corners(yy, xx, h, w):
    x0 = torch.floor(xx).clamp(0, w - 1)
    y0 = torch.floor(yy).clamp(0, h - 1)
    x1 = (x0 + 1).clamp(0, w - 1)
    y1 = (y0 + 1).clamp(0, h - 1)
    wx = (xx - x0).clamp(0.0, 1.0)
    wy = (yy - y0).clamp(0.0, 1.0)
    return y0, x0, y1, x1, wy, wx


def crop_and_resize_indexed(mask_stack, mask_idx, boxes, out_size: int):
    """Crop ``mask_stack[mask_idx[r]]`` to ``boxes[r]`` and resize it to
    (out_size, out_size) by bilinear sampling at the centres of an out_size
    grid spanning the box (border clamp).

    mask_stack: (G, H, W); mask_idx: (R,) int; boxes: (R, 4) image coords.
    Returns (R, out_size, out_size) float32."""
    _, h, w = mask_stack.shape
    r = boxes.shape[0]
    dev = boxes.device
    x1, y1, x2, y2 = boxes.float().unbind(-1)
    bw = (x2 - x1 + 1.0).clamp(min=1.0)
    bh = (y2 - y1 + 1.0).clamp(min=1.0)
    grid = (torch.arange(out_size, dtype=torch.float32, device=dev) + 0.5) / out_size
    ys = y1[:, None] + grid[None, :] * bh[:, None] - 0.5  # (R, o)
    xs = x1[:, None] + grid[None, :] * bw[:, None] - 0.5
    yy = ys[:, :, None].expand(r, out_size, out_size)
    xx = xs[:, None, :].expand(r, out_size, out_size)
    base = (mask_idx.long() * (h * w))[:, None, None]
    flat = mask_stack.reshape(-1).float()
    return _mix4(flat, base, w, *_corners(yy, xx, h, w))


def _bilinear_2d(img, y, x):
    """Bilinear sample of a single-channel (H, W) map at float coords,
    border clamp."""
    h, w = img.shape
    return _mix4(img.reshape(-1), 0, w, *_corners(y, x, h, w))


def paste_masks(masks, boxes, out_hw, binarize=None):
    """Paste per-instance mask patches into full-resolution planes (port of
    vps_tpu/ops/mask.py: paste_masks).

    masks (N, m, m) logits or probabilities; boxes (N, 4) in output
    coordinates; out_hw (H, W). Each output pixel inside box i (rounded to
    integers, w = max(x2 - x1 + 1, 1)) samples mask i bilinearly at the
    matching patch coordinate, border clamped; outside the box it is 0.
    Separable: the columns are mixed first for every patch row, then the
    rows, which is JAX's per-pixel order of operations (x-mix of each
    corner row, then the y-mix), without an (N, H, W) coordinate grid.

    Returns (N, H, W) float32; with ``binarize`` a float, 1.0 where the
    value is above it and 0.0 elsewhere."""
    h, w = out_hw
    n, m, _ = masks.shape
    dev = masks.device
    masks = masks.float()
    x1 = torch.round(boxes[:, 0])
    y1 = torch.round(boxes[:, 1])
    bw = (torch.round(boxes[:, 2]) - x1 + 1.0).clamp(min=1.0)
    bh = (torch.round(boxes[:, 3]) - y1 + 1.0).clamp(min=1.0)
    ys = torch.arange(h, dtype=torch.float32, device=dev)
    xs = torch.arange(w, dtype=torch.float32, device=dev)
    # image pixel centres in each patch's frame, (N, H) and (N, W)
    my = (ys[None] - y1[:, None] + 0.5) * (m / bh[:, None]) - 0.5
    mx = (xs[None] - x1[:, None] + 0.5) * (m / bw[:, None]) - 0.5
    y0, x0, yh, xh, wy, wx = _corners(my, mx, m, m)
    cols = lambda xi: masks.gather(  # noqa: E731  (N, m, W)
        2, xi.long()[:, None, :].expand(n, m, w))
    mixed = cols(x0) * (1 - wx[:, None, :]) + cols(xh) * wx[:, None, :]
    rows = lambda yi: mixed.gather(  # noqa: E731  (N, H, W)
        1, yi.long()[:, :, None].expand(n, h, w))
    vals = rows(y0) * (1 - wy[:, :, None]) + rows(yh) * wy[:, :, None]
    inside = (((my > -1.0) & (my < m))[:, :, None]
              & ((mx > -1.0) & (mx < m))[:, None, :])
    out = torch.where(inside, vals, torch.zeros_like(vals))
    if binarize is not None:
        out = (out > binarize).float()
    return out
