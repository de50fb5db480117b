"""Deformable convolution v1/v2 (port of vps_tpu/ops/deform_conv.py).

``deform_conv2d`` (one map) and ``deform_conv2d_multilevel`` (shared weight
over several levels) are plain PyTorch tensor code, as the JAX package's
versions are XLA compositions: per kernel tap, bilinear (or nearest) corner
gathers, then a (taps x Cin) -> Cout product accumulated in f32.

``deform_conv2d_windowed`` clamps each offset to [-window, window] and runs
a hand-written Hopper kernel (``vps_torch/csrc/deform_conv_windowed.cu``)
on CUDA tensors: bf16 inputs (every preset's) through one fused kernel that
gathers and mixes the bilinear samples and multiplies them with the weight
on the tensor cores, so the tap products never reach device memory; f32
inputs through the tap products Y_k = X W_k (one matmul) and a kernel that
mixes 4 corners of Y_k per tap. ``deform_conv2d_windowed_reference`` is the
plain version, taken only for CPU tensors and for the backward.

Offsets follow the CUDA layout: 2K channels, (dy, dx) pairs per tap
k = i * kw + j. Public functions are NHWC with the weight in torch layout
(Cout, Cin, kh, kw).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

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
    fused = lib.vps_deform_conv_windowed_fused
    if fused.argtypes is None:
        fused.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 8
                          + [ctypes.c_float, ctypes.c_void_p])
        fused.restype = ctypes.c_int
        plan = lib.vps_deform_conv_windowed_plan
        plan.argtypes = ([ctypes.c_int] * 8 + [ctypes.c_float]
                         + [ctypes.POINTER(ctypes.c_int)] * 2)
        plan.restype = ctypes.c_int
        mix = lib.vps_deform_conv_windowed_mix
        mix.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 7
                        + [ctypes.c_float, ctypes.c_void_p])
        mix.restype = ctypes.c_int
    return lib


def _aligned(t):
    """``t`` contiguous at a 16-byte-aligned address (a copy if need be)."""
    if not t.is_contiguous():
        t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


_FUSED_PLANS: dict = {}  # launch shape -> (bn, splits), from the library


def _fused_weight(weight, bn: int):
    """The fused kernel's weight: (Cout, Cin, kh, kw) -> (K, ceil(Cin / 64),
    Cout padded to a multiple of ``bn``, 64) bf16, zero-padded, with each
    row's 16-byte chunk c (8 channels) stored at c ^ (row % 8): the swizzle of
    the kernel's shared tiles, so that one bulk copy brings a whole (tap,
    channel chunk) tile in. Kept on the weight tensor until it changes in
    place. A weight cast anew for every call gets no use of it, which is why
    ``DeformConvWithOffset`` keeps its cast weight."""
    # an inference tensor has no version counter
    version = None if weight.is_inference() else weight._version
    key = (weight.data_ptr(), version, bn)
    cached = getattr(weight, "_vps_fused_weight", None)
    if cached is not None and cached[0] == key:
        return cached[1]
    cout, cin, kh, kw = weight.shape
    k, nck, cpad = kh * kw, -(-cin // 64), -(-cout // bn) * bn
    w = weight.detach().permute(2, 3, 0, 1).reshape(k, cout, cin)
    w = F.pad(w, (0, nck * 64 - cin, 0, cpad - cout))
    w = w.reshape(k, cpad, nck, 8, 8).permute(0, 2, 1, 3, 4)
    rows = torch.arange(cpad, device=w.device)
    src = torch.arange(8, device=w.device)[None, :] ^ (rows % 8)[:, None]
    w = torch.gather(w, 3, src[None, None, :, :, None].expand(k, nck, cpad, 8, 8))
    w = w.reshape(k, nck, cpad, 64)
    weight._vps_fused_weight = (key, w)
    return w


def windowed_fused(x, offset, weight, padding: int = 1, window: int = 4):
    """The bf16 route: one fused kernel gathers the 4 bilinear corners of x
    at each pixel's clamped position per tap, mixes them in f32, rounds the
    sample to bf16 and multiplies it with W_k on the tensor cores, summing
    over taps and input channels in f32. x (B, H, W, Cin) bf16 (16-byte
    corner reads where Cin % 8 == 0, else element-wise), offset (B, H, W,
    2K) f32, weight (Cout, Cin, kh, kw) bf16, all CUDA; returns (B, H, W,
    Cout) f32. A grid too small to fill the card
    splits the reduction over blocks: their partial sums go to a scratch
    tensor and a second kernel adds them in a fixed order."""
    b, h, w, cin = x.shape
    cout, _, kh, kw = weight.shape
    if x.device.type != "cuda" or x.dtype != torch.bfloat16:
        raise ValueError("windowed_fused: the kernel takes bf16 CUDA tensors")
    lib = _windowed_lib()
    key = (b, h, w, cin, cout, kh, kw, padding, float(window))
    plan = _FUSED_PLANS.get(key)
    if plan is None:
        bn, splits = ctypes.c_int(), ctypes.c_int()
        if not lib.vps_deform_conv_windowed_plan(*key, ctypes.byref(bn),
                                                 ctypes.byref(splits)):
            raise ValueError(f"windowed_fused: the kernel does not take x "
                             f"{tuple(x.shape)}, weight {tuple(weight.shape)}")
        plan = _FUSED_PLANS[key] = (bn.value, splits.value)
    bn, splits = plan
    x, offset = _aligned(x), _aligned(offset)
    wt = _fused_weight(weight, bn)
    out = torch.empty((b, h, w, cout), dtype=torch.float32, device=x.device)
    part = (torch.empty((splits, b, h, w, cout), dtype=torch.float32,
                        device=x.device) if splits > 1 else None)
    with cuda_build.on_device(x.device):
        rc = lib.vps_deform_conv_windowed_fused(
            x.data_ptr(), offset.data_ptr(), wt.data_ptr(), out.data_ptr(),
            None if part is None else part.data_ptr(), b, h, w, cin, cout, kh,
            kw, padding, float(window),
            cuda_build.stream_ptr(x.device))
    cuda_build.check(lib, rc, "fused windowed deformable conv kernel launch")
    with cuda_build.COUNT_LOCK:
        deform_conv2d_windowed.launches += 1
    return out


def windowed_tap_products(x, weight):
    """Y[b, y, x, k, :] = x[b, y, x, :] @ W_k (f32 route), one matmul of
    (B*H*W, Cin) by (Cin, K*Cout). The JAX package computes the same einsum
    outside its Pallas kernel."""
    b, h, w, cin = x.shape
    cout, _, kh, kw = weight.shape
    wmat = weight.permute(1, 2, 3, 0).reshape(cin, kh * kw * cout)
    return torch.matmul(x.reshape(b * h * w, cin), wmat).reshape(
        b, h, w, kh * kw, cout)


def windowed_mix(y, offset, kernel_size, padding: int = 1, window: int = 4):
    """The f32 route's kernel on precomputed tap products ``y`` (B, H, W, K,
    Cout) f32 and offsets (B, H, W, 2K) f32, CUDA and contiguous: out (B, H,
    W, Cout) f32 = sum over taps of the bilinear sample of Y_k at each
    pixel's clamped position."""
    kh, kw = kernel_size
    b, h, w, k, cout = y.shape
    if y.device.type != "cuda" or offset.device != y.device:
        raise ValueError("windowed_mix: the kernel takes CUDA tensors")
    if y.dtype != torch.float32:
        raise TypeError("windowed_mix: the mix kernel is the f32 route; bf16 "
                        "takes windowed_fused")
    if not (y.is_contiguous() and offset.is_contiguous()):
        raise ValueError("windowed_mix: the kernel takes contiguous tensors")
    if k != kh * kw or tuple(offset.shape) != (b, h, w, 2 * k):
        raise ValueError(f"windowed_mix: y {tuple(y.shape)} and offset "
                         f"{tuple(offset.shape)} do not agree")
    out = torch.empty((b, h, w, cout), dtype=torch.float32, device=y.device)
    lib = _windowed_lib()
    with cuda_build.on_device(y.device):
        rc = lib.vps_deform_conv_windowed_mix(
            y.data_ptr(), offset.data_ptr(), out.data_ptr(), b, h, w, cout,
            kh, kw, padding, float(window), cuda_build.stream_ptr(y.device))
    cuda_build.check(lib, rc, "windowed deformable conv kernel launch")
    with cuda_build.COUNT_LOCK:
        deform_conv2d_windowed.launches += 1
    return out


def _windowed_forward(x, offset, weight, padding, window):
    """A kernel on CUDA tensors (bf16: ``windowed_fused``; f32: the tap
    products, then ``windowed_mix``), the plain version on CPU ones."""
    if x.device.type == "cpu":
        return deform_conv2d_windowed_reference(x, offset, weight, padding,
                                                window)
    if x.dtype == torch.bfloat16:
        return windowed_fused(x, offset, weight, padding, window)
    y = windowed_tap_products(x, weight)
    return windowed_mix(y, offset.contiguous(), weight.shape[2:], padding,
                        window)


class _DeformConvWindowed(torch.autograd.Function):
    """Forward: ``_windowed_forward``. Backward: autograd through the plain
    version (JAX's ``_dcw_bwd``; there is no backward kernel on either
    side)."""

    @staticmethod
    def forward(ctx, x, offset, weight, padding, window):
        ctx.save_for_backward(x, offset, weight)
        ctx.conf = (padding, window)
        return _windowed_forward(x, offset, weight, padding, window)

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
    tensors go through a kernel or raise: bf16 through the fused
    gather-mix-product kernel, f32 through the tap products
    Y_k = x @ W_k and a 4-corner bilinear read of Y_k per tap. CPU tensors
    go through ``deform_conv2d_windowed_reference``."""
    _check_windowed(x, offset, weight, padding, window)
    if torch.is_grad_enabled() and (x.requires_grad or offset.requires_grad
                                    or weight.requires_grad):
        return _DeformConvWindowed.apply(x, offset, weight, padding, window)
    return _windowed_forward(x, offset, weight, padding, window)


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
