"""Least device time of the port's kernels on one H100, from their shapes.

Frozen copies of the bound arithmetic the port's chip script used
(``correlation_bound_ms``, ``correlation_backward_bound_ms``,
``windowed_bound_ms``): the larger of the bytes over the HBM rate and the
operations over the dtype's peak. Each input byte is counted read once and
each output byte written once. Peaks are NVIDIA's data sheet for the SXM
part at 700 W, dense.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
# float32 outside the tensor cores (TF32 is off in every policy the port
# runs); bf16 on the tensor cores
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}


def _esize(dtype_name: str) -> int:
    return 2 if dtype_name == "bfloat16" else 4


def _d2(md: int, s2: int) -> int:
    return (2 * (md // s2) + 1) ** 2


def _bound(nbytes: float, flops: float, dtype_name: str):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def correlation_bound_ms(shape, md, s2, dtype_name):
    """Forward cost volume of f1, f2 (B, H, W, C): both inputs read once,
    the (B, H, W, D^2) output written once; 2*B*H*W*D^2*C flops.
    Returns (ms, what bounds it)."""
    b, h, w, c = shape
    d2 = _d2(md, s2)
    nbytes = (2 * b * h * w * c + b * h * w * d2) * _esize(dtype_name)
    return _bound(nbytes, 2.0 * b * h * w * d2 * c, dtype_name)


def correlation_backward_bound_ms(shape, md, s2, dtype_name):
    """Both input gradients: f1, f2 and the output gradient read once, the
    two gradients written once; 4*B*H*W*D^2*C flops."""
    b, h, w, c = shape
    d2 = _d2(md, s2)
    nbytes = (4 * b * h * w * c + b * h * w * d2) * _esize(dtype_name)
    return _bound(nbytes, 4.0 * b * h * w * d2 * c, dtype_name)


def windowed_bound_ms(b, h, w, cin, cout, dtype_name, k=9):
    """The windowed DCN at one level, from x: the largest of the bytes (x,
    the f32 offsets and the weight read once, the f32 output written once),
    the products (2*Cin*k*Cout flops a pixel at the dtype's peak) and the
    bilinear mix (8 f32 flops a tap and channel over min(Cin, Cout))."""
    px = b * h * w
    times = {
        "bytes": (px * (cin * _esize(dtype_name) + 2 * k * 4 + cout * 4)
                  + k * cin * cout * _esize(dtype_name)) / HBM_BYTES_PER_S,
        "operations": max(
            2.0 * px * cin * k * cout / PEAK_FLOPS[dtype_name],
            8.0 * px * k * min(cin, cout) / PEAK_FLOPS["float32"]),
    }
    by = max(times, key=times.get)
    return times[by] * 1e3, by
