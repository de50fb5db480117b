"""The whole unit's share of the card's peak while the card works: the
least time of one unit's FLOPs at the peaks of the precisions the
configuration sets (counted on the plain reference, ``flops.py``), over the
card's busy seconds a unit in the traced window (the union of the kernel
intervals, from the device trace). The busy time, and not the window's
length, is the denominator: the profiler slows the host, and so the window,
but not the kernels. The card's idle share is ``device_idle``'s."""

from flops import least_seconds
from trace import busy_seconds


def read(ctx):
    busy = busy_seconds(ctx.trace)
    if not ctx.flops or not ctx.window.units or busy <= 0:
        return None
    return 100.0 * least_seconds(ctx.flops) * ctx.window.units / busy
