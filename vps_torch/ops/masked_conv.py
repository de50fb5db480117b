"""Masked conv2d (port of vps_tpu/ops/masked_conv.py): mmdet's MaskedConv2d,
which guided anchoring's cls and reg outputs use at inference.

mmdet's CUDA op im2cols only the masked output positions and writes zeros
elsewhere. JAX computes it as a dense convolution times the output mask,
which gives the same numbers; so does this port, with ``F.conv2d`` (NHWC in
and out, as the port's ops take it; the weight in torch layout).
"""

from __future__ import annotations

import torch.nn.functional as F


def masked_conv2d(x, mask, weight, bias=None, padding: int = 1):
    """x (B, H, W, Cin); mask (B, H, W) bool or float; weight (Cout, Cin,
    kh, kw); bias (Cout,) or None. Returns conv(x) * mask, (B, H, W, Cout):
    zero at the masked-out positions, as the CUDA op."""
    out = F.conv2d(x.permute(0, 3, 1, 2), weight, padding=padding)
    out = out.permute(0, 2, 3, 1)
    if bias is not None:
        out = out + bias
    return out * mask[..., None].to(out.dtype)
