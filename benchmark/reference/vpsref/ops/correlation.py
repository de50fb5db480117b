"""Correlation / cost volume, plain PyTorch on every device (a frozen copy
of the port's ``correlation_reference``): f1, f2 (B, H, W, C) -> (B, H, W,
D^2) with D = 2 * (md // stride2) + 1, displacements row-major with dy
outer, f2 zero outside the map, products and sums in f32, output in the
input dtype. Autograd differentiates it."""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

_DTYPES = (torch.float32, torch.bfloat16)


def _steps(max_displacement: int, stride2: int) -> int:
    return 2 * (max_displacement // stride2) + 1


def correlation_reference(f1, f2, max_displacement: int, stride2: int = 1):
    """Plain shift-multiply-mean version: products and sums in f32, then cast
    to the input dtype (the kernel's arithmetic, not _correlation_xla's
    bf16-rounded products)."""
    b, h, w, c = f1.shape
    md = max_displacement
    steps = _steps(md, stride2)
    a = f1.float()
    p = F.pad(f2.float(), (0, 0, md, md, md, md))
    outs = []
    for iy in range(steps):
        oy = iy * stride2  # row of displacement -md + iy * stride2 in p
        for ix in range(steps):
            ox = ix * stride2
            shifted = p[:, oy:oy + h, ox:ox + w, :]
            outs.append((a * shifted).sum(-1) / c)
    return torch.stack(outs, dim=-1).to(f1.dtype)


def _check(f1, f2, max_displacement, stride2):
    if f1.shape != f2.shape or f1.dim() != 4:
        raise ValueError(f"correlation: f1 {tuple(f1.shape)} and f2 "
                         f"{tuple(f2.shape)} must be equal (B, H, W, C)")
    if f1.dtype != f2.dtype or f1.dtype not in _DTYPES:
        raise TypeError(f"correlation: dtypes {f1.dtype}, {f2.dtype}; "
                        "need both float32 or both bfloat16")
    if f1.device != f2.device:
        raise ValueError("correlation: f1 and f2 on different devices")
    if max_displacement < 0 or stride2 < 1:
        raise ValueError("correlation: need max_displacement >= 0, stride2 >= 1")


def correlation(f1, f2, max_displacement: int, stride2: int = 1):
    """Cost volume through ``correlation_reference``."""
    _check(f1, f2, max_displacement, stride2)
    for calls in _RECORDERS:
        calls.append((tuple(f1.shape), max_displacement, stride2))
    return correlation_reference(f1, f2, max_displacement, stride2)


_RECORDERS = []  # the open record_calls lists


@contextlib.contextmanager
def record_calls():
    """While open, every call of ``correlation`` appends (f1's shape,
    max_displacement, stride2) to the yielded list."""
    calls = []
    _RECORDERS.append(calls)
    try:
        yield calls
    finally:
        _RECORDERS.remove(calls)


