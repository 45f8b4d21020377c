"""Device milliseconds a step of the operations launched inside the step's
``shade`` range (``render.render_step``), from a short eager pass at the
first pose that shares the scene's device tables: a replayed graph has no
stages to read."""


def read(ctx):
    if ctx.stage_trace is None or not ctx.stage_steps:
        return None
    us = ctx.stage_trace.launched_in("shade")
    return us / ctx.stage_steps / 1e3 if us > 0 else None
