"""Deformable convolution v1/v2 (port of vps_tpu/ops/deform_conv.py).

``deform_conv2d`` (one map) and ``deform_conv2d_multilevel`` (shared weight
over several levels) are plain PyTorch tensor code, as the JAX package's
versions are XLA compositions: per kernel tap, bilinear (or nearest) corner
gathers, then a (taps x Cin) -> Cout product accumulated in f32.

``deform_conv2d_windowed`` clamps each offset to [-window, window] and runs
the hand-written Hopper kernel (``vps_torch/csrc/deform_conv_windowed.cu``)
on CUDA tensors; ``deform_conv2d_windowed_reference`` is its plain version,
taken only for CPU tensors and for the backward.

Offsets follow the CUDA layout: 2K channels, (dy, dx) pairs per tap
k = i * kw + j. Public functions are NHWC with the weight in torch layout
(Cout, Cin, kh, kw).
"""

from __future__ import annotations

import ctypes

import torch

from vps_torch.ops import cuda_build

_DTYPES = (torch.float32, torch.bfloat16)


def _bilinear_corners(ys, xs):
    """(y, x, weight) of the four bilinear corners of f32 positions."""
    y0 = torch.floor(ys)
    x0 = torch.floor(xs)
    wy = ys - y0
    wx = xs - x0
    return ((y0, x0, (1 - wy) * (1 - wx)),
            (y0, x0 + 1, (1 - wy) * wx),
            (y0 + 1, x0, wy * (1 - wx)),
            (y0 + 1, x0 + 1, wy * wx))


def deform_conv2d(x, offset, weight, bias=None, stride: int = 1,
                  padding: int = 1, dilation: int = 1, mask=None,
                  sampling: str = "bilinear"):
    """Deformable conv v1 (v2 with ``mask``) on one map.

    x: (B, H, W, Cin); offset: (B, Ho, Wo, 2K); weight: (Cout, Cin, kh, kw);
    mask: (B, Ho, Wo, K) or None; bias: (Cout,) or None. Returns
    (B, Ho, Wo, Cout) float32. As in JAX: sample grids in f32 (a bf16 grid
    quantises positions past 256), corners mixed in f32 and cast to x's dtype
    before each tap's product, which accumulates in f32 against the weight
    as given (a bf16 x and an f32 weight multiply in f32). ``nearest``
    rounds each position (half to even) and takes one corner."""
    if sampling not in ("bilinear", "nearest"):
        raise ValueError(f"deform_conv2d: unknown sampling {sampling!r}")
    b, h, w, cin = x.shape
    cout, _, kh, kw = weight.shape
    k = kh * kw
    ho, wo = offset.shape[1:3]
    dt = x.dtype
    flat = x.reshape(b, h * w, cin)
    off = offset.reshape(b, ho, wo, k, 2)
    dev = x.device
    ys_grid = (torch.arange(ho, dtype=torch.float32, device=dev)[None, :, None]
               * stride - padding)
    xs_grid = (torch.arange(wo, dtype=torch.float32, device=dev)[None, None, :]
               * stride - padding)
    wmat = weight.float()
    out = torch.zeros((b, ho * wo, cout), dtype=torch.float32, device=dev)
    for ki in range(k):
        dy = (ki // kw) * dilation
        dx = (ki % kw) * dilation
        ys = ys_grid + dy + off[..., ki, 0]
        xs = xs_grid + dx + off[..., ki, 1]
        if sampling == "nearest":
            corners = ((torch.round(ys), torch.round(xs), torch.ones_like(ys)),)
        else:
            corners = _bilinear_corners(ys, xs)
        acc = 0.0
        for yy, xx, wgt in corners:
            inb = (yy >= 0) & (yy <= h - 1) & (xx >= 0) & (xx <= w - 1)
            idx = yy.clamp(0, h - 1).long() * w + xx.clamp(0, w - 1).long()
            vals = take_rows(flat, idx.reshape(b, -1))
            acc = acc + vals.float() * (wgt * inb).reshape(b, -1, 1)
        if mask is not None:
            acc = acc * mask[..., ki].reshape(b, -1, 1)
        out = out + acc.to(dt).float() @ wmat[:, :, ki // kw, ki % kw].t()
    out = out.reshape(b, ho, wo, cout)
    if bias is not None:
        out = out + bias
    return out


def deform_conv2d_windowed_reference(x, offset, weight, padding: int = 1,
                                     window: int = 4):
    """Plain version of the windowed kernel (JAX ``_windowed_ref``): clamp
    every (dy, dx) offset to [-window, window], then ``deform_conv2d``.
    Autograd through it is the true gradient of the clamped forward."""
    k = weight.shape[2] * weight.shape[3]
    off = offset.reshape(*offset.shape[:-1], k, 2).clamp(-float(window),
                                                         float(window))
    return deform_conv2d(x, off.reshape(offset.shape), weight,
                         padding=padding)


def _check_windowed(x, offset, weight, padding, window):
    if x.dim() != 4 or offset.dim() != 4 or weight.dim() != 4:
        raise ValueError("deform_conv2d_windowed: need x (B, H, W, Cin), "
                         "offset (B, H, W, 2K), weight (Cout, Cin, kh, kw)")
    b, h, w, cin = x.shape
    cout, wcin, kh, kw = weight.shape
    if wcin != cin or tuple(offset.shape) != (b, h, w, 2 * kh * kw):
        raise ValueError(
            f"deform_conv2d_windowed: x {tuple(x.shape)}, offset "
            f"{tuple(offset.shape)}, weight {tuple(weight.shape)} do not "
            "agree (stride 1: offsets at every input pixel)")
    if x.dtype not in _DTYPES or weight.dtype != x.dtype:
        raise TypeError(f"deform_conv2d_windowed: x {x.dtype}, weight "
                        f"{weight.dtype}; need both float32 or both bfloat16")
    if offset.dtype != torch.float32:
        raise TypeError(f"deform_conv2d_windowed: offset {offset.dtype}; "
                        "need float32")
    if not (x.device == offset.device == weight.device):
        raise ValueError("deform_conv2d_windowed: x, offset and weight on "
                         "different devices")
    if window < 0 or padding < 0:
        raise ValueError("deform_conv2d_windowed: need window >= 0, "
                         "padding >= 0")


def _windowed_lib():
    lib = cuda_build.load("deform_conv_windowed.cu")
    fn = lib.vps_deform_conv_windowed_forward
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 8
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def windowed_tap_products(x, weight):
    """Y[b, y, x, k, :] = x[b, y, x, :] @ W_k in x's dtype (f32
    accumulation), one matmul of (B*H*W, Cin) by (Cin, K*Cout). The JAX
    package computes the same einsum outside its Pallas kernel."""
    b, h, w, cin = x.shape
    cout, _, kh, kw = weight.shape
    wmat = weight.permute(1, 2, 3, 0).reshape(cin, kh * kw * cout)
    return torch.matmul(x.reshape(b * h * w, cin), wmat).reshape(
        b, h, w, kh * kw, cout)


def windowed_mix(y, offset, kernel_size, padding: int = 1, window: int = 4):
    """Launch the kernel on precomputed tap products ``y`` (B, H, W, K, Cout)
    (bf16 or f32, contiguous) and f32 offsets (B, H, W, 2K) (contiguous):
    out (B, H, W, Cout) f32 = sum over taps of the bilinear sample of Y_k at
    each pixel's clamped position. CUDA tensors only."""
    kh, kw = kernel_size
    b, h, w, k, cout = y.shape
    if y.device.type != "cuda" or offset.device != y.device:
        raise ValueError("windowed_mix: the kernel takes CUDA tensors")
    if not (y.is_contiguous() and offset.is_contiguous()):
        raise ValueError("windowed_mix: the kernel takes contiguous tensors")
    if k != kh * kw or tuple(offset.shape) != (b, h, w, 2 * k):
        raise ValueError(f"windowed_mix: y {tuple(y.shape)} and offset "
                         f"{tuple(offset.shape)} do not agree")
    out = torch.empty((b, h, w, cout), dtype=torch.float32, device=y.device)
    lib = _windowed_lib()
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream(y.device).cuda_stream
        rc = lib.vps_deform_conv_windowed_forward(
            y.data_ptr(), offset.data_ptr(), out.data_ptr(), b, h, w, cout,
            kh, kw, padding, int(y.dtype == torch.bfloat16), float(window),
            stream)
    cuda_build.check(lib, rc, "windowed deformable conv kernel launch")
    deform_conv2d_windowed.launches += 1
    return out


class _DeformConvWindowed(torch.autograd.Function):
    """Forward: the kernel on CUDA tensors, the plain version on CPU ones.
    Backward: autograd through the plain version (JAX's ``_dcw_bwd``; there
    is no backward kernel on either side)."""

    @staticmethod
    def forward(ctx, x, offset, weight, padding, window):
        ctx.save_for_backward(x, offset, weight)
        ctx.conf = (padding, window)
        if x.device.type == "cpu":
            return deform_conv2d_windowed_reference(x, offset, weight,
                                                    padding, window)
        y = windowed_tap_products(x, weight)
        return windowed_mix(y, offset.contiguous(), weight.shape[2:],
                            padding, window)

    @staticmethod
    def backward(ctx, grad):
        padding, window = ctx.conf
        inputs = [t.detach().requires_grad_(need) for t, need in
                  zip(ctx.saved_tensors, ctx.needs_input_grad[:3])]
        with torch.enable_grad():
            out = deform_conv2d_windowed_reference(*inputs, padding, window)
            wanted = [t for t in inputs if t.requires_grad]
            grads = iter(torch.autograd.grad(out, wanted, grad))
        return (*(next(grads) if t.requires_grad else None for t in inputs),
                None, None)


def deform_conv2d_windowed(x, offset, weight, padding: int = 1,
                           window: int = 4):
    """Offset-clamped deformable conv v1 (JAX ``deform_conv2d_windowed``):
    no bias, no mask, stride 1, offsets clamped to [-window, window].

    x: (B, H, W, Cin) f32 or bf16; offset: (B, H, W, 2K) f32; weight:
    (Cout, Cin, kh, kw) in x's dtype. Returns (B, H, W, Cout) f32. CUDA
    tensors go through the kernel (Y_k = x @ W_k in x's dtype, then a
    4-corner bilinear read of Y_k per tap) or raise; CPU tensors through
    ``deform_conv2d_windowed_reference``."""
    _check_windowed(x, offset, weight, padding, window)
    return _DeformConvWindowed.apply(x, offset, weight, padding, window)


deform_conv2d_windowed.launches = 0  # kernel launches (CUDA path only)


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
                corners = _bilinear_corners(ys, xq)
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
