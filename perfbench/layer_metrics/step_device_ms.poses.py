"""Device milliseconds a captured step: the union of the kernel, copy and
memset intervals inside the profiled windows (a few steady steps at each
pose), over the steps profiled."""

from perfbench.trace import length


def read(ctx):
    if ctx.trace is None or not ctx.profiled_steps:
        return None
    busy = length(ctx.trace.busy(ctx.windows))
    return busy / ctx.profiled_steps / 1e3 if busy > 0 else None
