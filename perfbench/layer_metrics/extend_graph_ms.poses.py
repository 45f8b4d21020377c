"""Milliseconds a step of the ``extend`` stage inside the replayed step:
from its device marker to ``shade``'s (``render.render_step`` under the
program's tracer, a graph node each), the mean over the window of the
tracer's pass (``perfbench/tracer.py``)."""

from perfbench import tracer


def read(ctx):
    return tracer.stage_ms(ctx, "extend", "shade")
