"""Share of the correlation kernels' roofline in the traced window: the
summed least times (``roofline.py``) of every correlation the program ran,
at each call's shape (the program's own record of its calls), over the
summed device time of the kernels (``corr_bf16_tc``, ``corr_f32``,
``corr_backward``). A call's backward is counted where the cell's traffic
lists its (max displacement, stride) as differentiated. Nothing when the
launches do not pair one to one with the recorded calls."""

from roofline import correlation_backward_bound_ms, correlation_bound_ms
from trace import kernel_seconds

FORWARD = ("corr_bf16_tc", "corr_f32")
BACKWARD = ("corr_backward",)


def read(ctx):
    if ctx.calls is None or not ctx.calls:
        return None
    dtype = ctx.cell["correlation_dtype"]
    diff = [list(d) for d in ctx.cell["traffic"].get(
        "differentiated_correlations", [])]
    fwd_s, fwd_n = kernel_seconds(ctx.trace, FORWARD)
    bwd_s, bwd_n = kernel_seconds(ctx.trace, BACKWARD)
    back = [c for c in ctx.calls if [c[1], c[2]] in diff]
    if fwd_n != len(ctx.calls) or bwd_n != len(back) or fwd_s + bwd_s <= 0:
        return None
    bound = sum(correlation_bound_ms(s, md, s2, dtype)[0]
                for s, md, s2 in ctx.calls)
    bound += sum(correlation_backward_bound_ms(s, md, s2, dtype)[0]
                 for s, md, s2 in back)
    return 100.0 * bound / ((fwd_s + bwd_s) * 1e3)
