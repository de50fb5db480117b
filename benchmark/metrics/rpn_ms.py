"""Host milliseconds a unit inside the program's ``rpn`` range (the RPN
head, its proposals and their NMS), over the traced window's units."""

from trace import range_host_seconds


def read(ctx):
    if "rpn" not in ctx.trace.ranges or not ctx.window.units:
        return None
    return range_host_seconds(ctx.trace, "rpn") * 1e3 / ctx.window.units
