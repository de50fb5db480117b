"""The controls: the reference computed one precision below the one the
configuration states, which the comparison has to call wrong.

``tf32``: float32 work with TF32 on (matmuls and cuDNN), for a
configuration that states float32 with TF32 off. ``fp8``: for conv stacks
the configuration runs in bfloat16, each convolution's input and weight
rounded to float8 e4m3 (scaled per tensor to its largest magnitude, as fp8
inference scales them) before the bf16 convolution.

``split`` is no control but a sound variant of the reference: float32
with TF32 off as stated, each float32 convolution and linear map summed
over its input channels in two halves, so that its sums round in another
order. Its readings against the reference are those of a sound program
that rounds differently.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

E4M3_MAX = 448.0


def fp8_round(t):
    """``t`` rounded to float8 e4m3 under a per-tensor scale, in t's dtype."""
    scale = t.detach().abs().amax().float().clamp(min=1e-30) / E4M3_MAX
    q = (t.float() / scale).to(torch.float8_e4m3fn).float() * scale
    return q.to(t.dtype)


@contextlib.contextmanager
def _fp8_convs():
    conv2d, conv_t = F.conv2d, F.conv_transpose2d

    def wrap(fn):
        def run(x, w, *args, **kw):
            if x.dtype == torch.bfloat16:
                x, w = fp8_round(x), fp8_round(w)
            return fn(x, w, *args, **kw)
        return run

    F.conv2d, F.conv_transpose2d = wrap(conv2d), wrap(conv_t)
    try:
        yield
    finally:
        F.conv2d, F.conv_transpose2d = conv2d, conv_t


@contextlib.contextmanager
def _tf32():
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


@contextlib.contextmanager
def _split():
    conv2d, linear = F.conv2d, F.linear

    def halves(fn, x, w, bias=None, *args, **kw):
        c = w.shape[1] // 2
        if x.dtype != torch.float32 or c == 0 or kw.get("groups", 1) != 1 \
                or (len(args) >= 4 and args[3] != 1):
            return fn(x, w, bias, *args, **kw)
        return (fn(x[:, :c], w[:, :c], None, *args, **kw)
                + fn(x[:, c:], w[:, c:], bias, *args, **kw))

    F.conv2d = lambda *a, **kw: halves(conv2d, *a, **kw)
    F.linear = lambda x, w, b=None: (
        linear(x, w, b) if x.dtype != torch.float32 or w.shape[1] < 2 else
        linear(x[..., :w.shape[1] // 2], w[:, :w.shape[1] // 2])
        + linear(x[..., w.shape[1] // 2:], w[:, w.shape[1] // 2:], b))
    try:
        yield
    finally:
        F.conv2d, F.linear = conv2d, linear


def context(name):
    """The control ``name`` (None: the reference as the configuration
    states it)."""
    if name is None:
        return contextlib.nullcontext()
    return {"tf32": _tf32, "fp8": _fp8_convs, "split": _split}[name]()
