"""Share of the traced window in which no kernel ran on the card: one less
the union of the kernel intervals over the window (the union, since the
video cell's two CUDA streams overlap)."""

from trace import busy_seconds, window_seconds


def read(ctx):
    win = window_seconds(ctx.trace)
    if win <= 0 or not ctx.trace.by_name:
        return None
    return 100.0 * (1.0 - busy_seconds(ctx.trace) / win)
