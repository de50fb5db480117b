"""Deformable convolution v1, forward (port of
vps_tpu/ops/deform_conv.py:deform_conv2d_multilevel).

Plain PyTorch tensor code, as the JAX package's version is an XLA
composition: per kernel tap, bilinear (or nearest) corner gathers over ONE
table that concatenates every level, then a (taps x Cin) -> Cout product
accumulated in f32. Offsets follow the CUDA layout: 2K channels, (dy, dx)
pairs per tap k = i * kw + j.
"""

from __future__ import annotations

import torch


def take_rows(flat, idx):
    """flat (B, N, C), idx (B, M) -> (B, M, C)."""
    b, n, c = flat.shape
    base = (torch.arange(b, device=idx.device) * n)[:, None]
    return flat.reshape(b * n, c).index_select(
        0, (idx + base).reshape(-1)).reshape(b, -1, c)


def deform_conv2d_multilevel(xs, offsets, weight, padding: int = 1,
                             sampling: str = "bilinear"):
    """Shared-weight deformable conv over several levels.

    xs: list of (B, H_l, W_l, Cin); offsets: list of (B, H_l, W_l, 2K) f32;
    weight: (Cout, Cin, kh, kw) (torch layout). Returns a list of
    (B, H_l, W_l, Cout) float32. The sampled values are mixed in f32, cast to
    the input dtype, and each tap's product runs on those values with f32
    accumulation (JAX's preferred_element_type=float32)."""
    b, _, _, cin = xs[0].shape
    cout, _, kh, kw = weight.shape
    k = kh * kw
    dt = xs[0].dtype
    shapes = [tuple(x.shape[1:3]) for x in xs]
    sizes = [h * w for h, w in shapes]
    bases = [sum(sizes[:i]) for i in range(len(sizes))]
    flat = torch.cat([x.reshape(b, s, cin) for x, s in zip(xs, sizes)], 1)
    offs = [o.reshape(b, h, w, k, 2).float() for o, (h, w) in zip(offsets, shapes)]
    dev = flat.device
    grids = [(torch.arange(h, dtype=torch.float32, device=dev)[None, :, None] - padding,
              torch.arange(w, dtype=torch.float32, device=dev)[None, None, :] - padding)
             for h, w in shapes]
    wmat = weight.to(dt).float()  # bf16-rounded weights, f32 products

    out = torch.zeros((b, sum(sizes), cout), dtype=torch.float32, device=dev)
    for ki in range(k):
        dy, dx = ki // kw, ki % kw
        n_corners = 1 if sampling == "nearest" else 4
        idx_parts = [[] for _ in range(n_corners)]
        wgt_parts = [[] for _ in range(n_corners)]
        for (h, w), (ys_g, xs_g), off, base in zip(shapes, grids, offs, bases):
            ys = ys_g + dy + off[..., ki, 0]
            xq = xs_g + dx + off[..., ki, 1]
            if sampling == "nearest":
                corners = ((torch.round(ys), torch.round(xq),
                            torch.ones_like(ys)),)
            else:
                y0 = torch.floor(ys)
                x0 = torch.floor(xq)
                wy = ys - y0
                wx = xq - x0
                corners = (
                    (y0, x0, (1 - wy) * (1 - wx)),
                    (y0, x0 + 1, (1 - wy) * wx),
                    (y0 + 1, x0, wy * (1 - wx)),
                    (y0 + 1, x0 + 1, wy * wx),
                )
            for ci, (yy, xx, wgt) in enumerate(corners):
                inb = (yy >= 0) & (yy <= h - 1) & (xx >= 0) & (xx <= w - 1)
                idx = (yy.clamp(0, h - 1).long() * w
                       + xx.clamp(0, w - 1).long() + base)
                idx_parts[ci].append(idx.reshape(b, -1))
                wgt_parts[ci].append((wgt * inb).reshape(b, -1))
        acc = 0.0
        for ci in range(n_corners):
            vals = take_rows(flat, torch.cat(idx_parts[ci], 1))
            acc = acc + vals.float() * torch.cat(wgt_parts[ci], 1)[..., None]
        out = out + acc.to(dt).float() @ wmat[:, :, dy, dx].t()
    return [out[:, base:base + s].reshape(b, h, w, cout)
            for base, s, (h, w) in zip(bases, sizes, shapes)]
