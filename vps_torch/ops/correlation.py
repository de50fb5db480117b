"""Correlation / cost volume (port of vps_tpu/ops/correlation.py).

``correlation`` launches a hand-written Hopper kernel
(``vps_torch/csrc/correlation.cu``) on CUDA tensors and takes the plain
PyTorch version, ``correlation_reference``, only for CPU tensors. Layout is
NHWC at the public function, as in the JAX package: f1, f2 (B, H, W, C) ->
(B, H, W, D^2) with D = 2 * (md // stride2) + 1, displacements row-major with
dy outer, f2 zero outside the map, f32 accumulation, output in the input
dtype.

Routes on the card, by dtype:
  * bfloat16 (the ``half-flow`` and faster presets): a band product on the
    tensor cores (mma.sync, bf16 in, f32 sums). One block per output row
    segment walks all D displacement rows with its f1 segment in registers
    (staged with each f2 row instead where C > 256) and the f2 rows streamed
    in by cp.async.
  * float32 (the ``exact`` preset and training): a register-tiled band
    product on the CUDA cores with f32 products, since the tensor cores would
    round its inputs to TF32. A block owns an output row segment of 2 or 4
    rows, stride2 apart, and walks every displacement row; each thread keeps
    the sums of 2 rows x 4 pixels x a group of dx of one staged f2 row in
    registers, fed by 16-byte shared loads from a cp.async ring.

When a gradient is needed (training: LiteFlowNetCorr's inputs are trained
features), ``correlation`` runs inside ``_Correlation``, a
``torch.autograd.Function`` whose backward is a second kernel,
``correlation_backward``: both input gradients in one launch, each a
register-tiled band product on the CUDA cores (f32 products and sums, f32 or
bf16 in and out, every output written by one thread: deterministic). A
block owns 4 output rows of 16 pixels and stages every feature row the 4
share once, by cp.async into a ring; each thread keeps the sums of 2 rows x
4 pixels x 8 channels, and two blocks share an SM. Without a gradient
(inference, FlowNetC under no_grad) autograd is bypassed. On the CPU the plain version runs, and autograd goes
through it (``correlation_backward_reference``).
"""

from __future__ import annotations

import contextlib
import ctypes

import torch
import torch.nn.functional as F

from vps_torch.ops import cuda_build

_DTYPES = (torch.float32, torch.bfloat16)
MAX_STEPS = 41  # largest displacement grid side the kernel is built for


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


def correlation_backward_reference(g, f1, f2, max_displacement: int,
                                   stride2: int = 1):
    """Plain backward: autograd through ``correlation_reference`` (f32
    products and sums, gradients cast to the input dtype). Returns
    (grad_f1, grad_f2)."""
    a = f1.detach().requires_grad_(True)
    b = f2.detach().requires_grad_(True)
    with torch.enable_grad():
        out = correlation_reference(a, b, max_displacement, stride2)
        return torch.autograd.grad(out, (a, b), g)


def _lib():
    lib = cuda_build.load("correlation.cu")
    fn = lib.vps_correlation_forward
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        bwd = lib.vps_correlation_backward
        bwd.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        bwd.restype = ctypes.c_int
    return lib


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


def _check_kernel(f1, f2, max_displacement, stride2):
    """What the CUDA kernels take (raises on anything else)."""
    if f1.device.type != "cuda":
        raise ValueError(f"correlation: unsupported device {f1.device}")
    if not (f1.is_contiguous() and f2.is_contiguous()):
        raise ValueError("correlation: the kernel takes contiguous NHWC tensors")
    steps = _steps(max_displacement, stride2)
    if steps > MAX_STEPS or max_displacement > 96:
        raise ValueError(f"correlation: {steps} displacement steps per axis "
                         f"(md {max_displacement}) exceed the kernel's "
                         f"{MAX_STEPS} / md 96")


def _forward(f1, f2, max_displacement, stride2):
    """The forward kernel on checked CUDA tensors."""
    _check_kernel(f1, f2, max_displacement, stride2)
    b, h, w, c = f1.shape
    steps = _steps(max_displacement, stride2)
    bf16 = f1.dtype == torch.bfloat16
    if h > 65535 or b > 65535:
        raise ValueError("correlation: grid too large (H or B > 65535)")
    lib = _lib()
    out = torch.empty((b, h, w, steps * steps), dtype=f1.dtype,
                      device=f1.device)
    with cuda_build.on_device(f1.device):
        rc = lib.vps_correlation_forward(
            f1.data_ptr(), f2.data_ptr(), out.data_ptr(), b, h, w, c,
            max_displacement, stride2, int(bf16),
            cuda_build.stream_ptr(f1.device))
    cuda_build.check(lib, rc, "correlation kernel launch")
    with cuda_build.COUNT_LOCK:
        correlation.launches += 1
        correlation.route_launches["corr_bf16_tc" if bf16 else "corr_f32"] += 1
    return out


class _Correlation(torch.autograd.Function):
    """Forward: the forward kernel. Backward: ``correlation_backward``, the
    backward kernel (JAX's ``_correlation_bwd``, the VJP of
    ``_correlation_xla``)."""

    @staticmethod
    def forward(ctx, f1, f2, max_displacement, stride2):
        ctx.save_for_backward(f1, f2)
        ctx.conf = (max_displacement, stride2)
        return _forward(f1, f2, max_displacement, stride2)

    @staticmethod
    def backward(ctx, g):
        f1, f2 = ctx.saved_tensors
        gf1, gf2 = correlation_backward(g.contiguous(), f1, f2, *ctx.conf)
        need1, need2 = ctx.needs_input_grad[:2]
        return (gf1 if need1 else None), (gf2 if need2 else None), None, None


def correlation(f1, f2, max_displacement: int, stride2: int = 1):
    """Cost volume. CUDA tensors go through the kernel (or raise), inside
    ``_Correlation`` when a gradient is needed; CPU tensors through
    ``correlation_reference``, which autograd differentiates."""
    _check(f1, f2, max_displacement, stride2)
    for calls in _RECORDERS:
        calls.append((tuple(f1.shape), max_displacement, stride2))
    if f1.device.type == "cpu":
        return correlation_reference(f1, f2, max_displacement, stride2)
    if torch.is_grad_enabled() and (f1.requires_grad or f2.requires_grad):
        return _Correlation.apply(f1, f2, max_displacement, stride2)
    return _forward(f1, f2, max_displacement, stride2)


_RECORDERS = []  # the open record_calls lists


@contextlib.contextmanager
def record_calls():
    """While open, every call of ``correlation``, on either device, appends
    (f1's shape, max_displacement, stride2) to the yielded list."""
    calls = []
    _RECORDERS.append(calls)
    try:
        yield calls
    finally:
        _RECORDERS.remove(calls)


def correlation_backward(g, f1, f2, max_displacement: int, stride2: int = 1):
    """(grad_f1, grad_f2) of ``correlation`` for the output gradient g
    (B, H, W, D^2) in the inputs' dtype. CUDA tensors go through the backward
    kernel (or raise); CPU tensors through
    ``correlation_backward_reference``."""
    _check(f1, f2, max_displacement, stride2)
    b, h, w, c = f1.shape
    d2 = _steps(max_displacement, stride2) ** 2
    if tuple(g.shape) != (b, h, w, d2) or g.dtype != f1.dtype:
        raise ValueError(f"correlation_backward: g {tuple(g.shape)} {g.dtype}"
                         f", need {(b, h, w, d2)} {f1.dtype}")
    if f1.device.type == "cpu":
        return correlation_backward_reference(g, f1, f2, max_displacement,
                                              stride2)
    _check_kernel(f1, f2, max_displacement, stride2)
    if g.device != f1.device or not g.is_contiguous():
        raise ValueError("correlation_backward: g must be a contiguous "
                         "tensor on the inputs' device")
    lib = _lib()
    gf1 = torch.empty_like(f1)
    gf2 = torch.empty_like(f2)
    with cuda_build.on_device(f1.device):
        rc = lib.vps_correlation_backward(
            g.data_ptr(), f1.data_ptr(), f2.data_ptr(), gf1.data_ptr(),
            gf2.data_ptr(), b, h, w, c, max_displacement, stride2,
            int(f1.dtype == torch.bfloat16), cuda_build.stream_ptr(f1.device))
    cuda_build.check(lib, rc, "correlation backward kernel launch")
    with cuda_build.COUNT_LOCK:
        correlation_backward.launches += 1
        correlation_backward.route_launches[
            "bf16" if f1.dtype == torch.bfloat16 else "f32"] += 1
    return gf1, gf2


correlation.launches = 0  # forward kernel launches (CUDA path only)
# the same launches by the kernel that ran: bf16 and f32 routes
correlation.route_launches = {"corr_bf16_tc": 0, "corr_f32": 0}
correlation_backward.launches = 0  # backward kernel launches (CUDA path only)
# the same launches by the route that ran: f32 or bf16 in and out
correlation_backward.route_launches = {"f32": 0, "bf16": 0}
