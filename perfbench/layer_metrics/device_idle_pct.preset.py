"""The device's idle share of the profiled steady frames (move, step,
display and the copy out): 1 - the union of its busy intervals over the
profiled window's wall time, in percent.  The profiler slows the host, so
this is an upper bound.  ``device_idle_pct.fly`` of the interactive
preset, where it moves ``fps.preset``."""


def read(ctx):
    return None if ctx.trace is None else ctx.trace.idle_pct(ctx.windows)
