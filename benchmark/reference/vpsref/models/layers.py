"""Shared layers (port of vps_tpu/models/layers.py), NCHW inside modules.

Compute dtypes follow the JAX package's rule exactly: a conv with a compute
dtype casts its input, weight and bias to it; a conv without one computes in
float32 (flax promotes any input against the f32 parameters), or in float64
when its input and weight both are (a reference run in double precision).
Resizes and pools use torch's own ``F.interpolate`` / pooling semantics,
computed in f32 and cast back to the input dtype.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

DTYPES = {None: None, "float32": None, "bfloat16": torch.bfloat16}


def compute_dtype(name: Optional[str], default=None):
    """Config string -> torch dtype (None = f32 compute)."""
    if name is None:
        return default
    return DTYPES[name]


def leaky_relu(x):
    return F.leaky_relu(x, 0.1)


class Conv(nn.Conv2d):
    """Conv2d with torch padding semantics and an explicit compute dtype;
    parameters stay float32."""

    def __init__(self, in_channels, out_channels, kernel_size=3, stride=1,
                 padding=0, bias=True, dtype: Optional[torch.dtype] = None,
                 device=None, groups: int = 1, dilation: int = 1):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, dilation, bias=bias, device=device,
                         groups=groups)
        self.compute_dtype = dtype

    def forward(self, x):
        # without a compute dtype: f32, or f64 when both are (a float64
        # reference run)
        dt = self.compute_dtype or torch.promote_types(x.dtype,
                                                       self.weight.dtype)
        b = None if self.bias is None else self.bias.to(dt)
        return F.conv2d(x.to(dt), self.weight.to(dt), b, self.stride,
                        self.padding, self.dilation, self.groups)


class ConvTranspose(nn.ConvTranspose2d):
    """ConvTranspose2d(k, stride, padding) with an explicit compute dtype."""

    def __init__(self, in_channels, out_channels, kernel_size=4, stride=2,
                 padding=1, bias=True, dtype: Optional[torch.dtype] = None,
                 device=None):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, bias=bias, device=device)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype or torch.float32
        b = None if self.bias is None else self.bias.to(dt)
        return F.conv_transpose2d(x.to(dt), self.weight.to(dt), b,
                                  self.stride, self.padding)


def ConvTranspose2x(in_channels, out_channels, device=None):
    """torch ConvTranspose2d(kernel=2, stride=2) used by the mask head."""
    return ConvTranspose(in_channels, out_channels, 2, 2, 0, device=device)


class FrozenBatchNorm(nn.Module):
    """BatchNorm in eval mode (mmdet norm_eval=True): folded in f32, applied
    in the input's dtype."""

    def __init__(self, features: int, eps: float = 1e-5, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))
        self.register_buffer("running_mean", torch.zeros(features, device=device))
        self.register_buffer("running_var", torch.ones(features, device=device))

    def forward(self, x):
        inv = self.weight * torch.rsqrt(self.running_var + self.eps)
        shift = self.bias - self.running_mean * inv
        return (x * inv.to(x.dtype)[:, None, None]
                + shift.to(x.dtype)[:, None, None])


class ConvModule(nn.Module):
    """conv (+ GroupNorm) (+ ReLU), mmdet ConvModule naming (``.conv``,
    ``.gn``): with ``gn_groups`` the conv has no bias and GroupNorm
    (eps 1e-5) follows it, as FCOS's towers."""

    def __init__(self, in_channels, out_channels, kernel_size=3, stride=1,
                 padding=0, relu: bool = True,
                 dtype: Optional[torch.dtype] = None, device=None,
                 gn_groups: Optional[int] = None):
        super().__init__()
        self.conv = Conv(in_channels, out_channels, kernel_size, stride,
                         padding, bias=gn_groups is None, dtype=dtype,
                         device=device)
        self.gn = (None if gn_groups is None else
                   nn.GroupNorm(gn_groups, out_channels, eps=1e-5,
                                device=device))
        self.relu = relu

    def forward(self, x):
        x = self.conv(x)
        if self.gn is not None:
            x = self.gn(x)
        return F.relu(x) if self.relu else x


# ---------------------------------------------------------------------------
# Resizing / pooling (NCHW), torch semantics computed in f32
# ---------------------------------------------------------------------------


def resize_bilinear(x, size: Tuple[int, int]):
    """F.interpolate(mode='bilinear', align_corners=False) in f32."""
    if tuple(size) == tuple(x.shape[-2:]):
        return x
    y = F.interpolate(x.float(), size=tuple(size), mode="bilinear",
                      align_corners=False)
    return y.to(x.dtype)


def resize_nearest(x, size: Tuple[int, int]):
    """F.interpolate(mode='nearest'): src = floor(dst * in / out)."""
    if tuple(size) == tuple(x.shape[-2:]):
        return x
    return F.interpolate(x.float(), size=tuple(size), mode="nearest").to(x.dtype)


def max_pool(x, kernel: int, stride: int, padding: int = 0):
    """MaxPool2d(kernel, stride, padding), floor mode."""
    return F.max_pool2d(x, kernel, stride, padding)


def avg_pool(x, kernel: int, stride: int, padding: int = 0):
    """AvgPool2d with count_include_pad=True."""
    return F.avg_pool2d(x, kernel, stride, padding, count_include_pad=True)


class _AdaptiveMaxPoolDeterministic(torch.autograd.Function):
    """F.adaptive_max_pool2d with a backward in a fixed order: each window's
    gradient added at its argmax by one ``index_add_`` (deterministic under
    ``torch.use_deterministic_algorithms``); windows that overlap and share
    an argmax add up, as the library's atomics do."""

    @staticmethod
    def forward(ctx, x, out_size):
        out, idx = F.adaptive_max_pool2d(x, out_size, return_indices=True)
        ctx.save_for_backward(idx)
        ctx.in_shape = x.shape
        return out

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        b, c, h, w = ctx.in_shape
        plane = (torch.arange(b * c, device=g.device) * (h * w))[:, None]
        flat = (idx.reshape(b * c, -1) + plane).reshape(-1)
        gx = g.new_zeros(b * c * h * w).index_add_(0, flat, g.reshape(-1))
        return gx.reshape(b, c, h, w), None


def adaptive_max_pool_deterministic(x, out_size: Tuple[int, int]):
    """F.adaptive_max_pool2d(x, out_size), bit for bit, whose backward adds
    in a fixed order."""
    return _AdaptiveMaxPoolDeterministic.apply(x, tuple(out_size))


def adaptive_max_pool(x, out_size: Tuple[int, int]):
    """F.adaptive_max_pool2d: window i = [floor(i*H/out), ceil((i+1)*H/out)).
    Under torch.use_deterministic_algorithms (``train_policy``) its backward
    is ``adaptive_max_pool_deterministic``'s: the card's library backward
    adds with atomics and has no deterministic form."""
    if tuple(out_size) == tuple(x.shape[-2:]):
        return x
    if (torch.are_deterministic_algorithms_enabled()
            and torch.is_grad_enabled()
            and x.requires_grad):
        return adaptive_max_pool_deterministic(x, out_size)
    return F.adaptive_max_pool2d(x, tuple(out_size))
