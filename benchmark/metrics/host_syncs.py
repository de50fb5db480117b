"""Host syncs a unit (frame, step or image): the program's
``aten::_local_scalar_dense`` ops (an item, bool or int of a device tensor)
in the traced window, over the units the window completed."""


def read(ctx):
    if not ctx.window.units:
        return None
    return ctx.trace.syncs / ctx.window.units
