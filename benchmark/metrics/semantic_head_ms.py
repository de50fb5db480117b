"""Host milliseconds a unit inside the program's ``semantic_head`` range
(the UPSNet head, its deformable convs dispatched from the host), summed
over the traced window's ranges on every thread, over its units."""

from trace import range_host_seconds


def read(ctx):
    if "semantic_head" not in ctx.trace.ranges or not ctx.window.units:
        return None
    return range_host_seconds(ctx.trace, "semantic_head") * 1e3 / ctx.window.units
