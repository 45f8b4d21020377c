"""The device's idle share of the profiled steady steps: 1 - the union of
its busy intervals over the profiled windows' wall time, in percent.  The
profiler slows the host, so this is an upper bound."""


def read(ctx):
    return None if ctx.trace is None else ctx.trace.idle_pct(ctx.windows)
