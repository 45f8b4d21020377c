"""Milliseconds a step of the ``connect`` stage (the shadow rays' any
hit) inside the replayed step: from its device marker to ``sort``'s, the
mean over the window of the tracer's pass (``perfbench/tracer.py``)."""

from perfbench import tracer


def read(ctx):
    return tracer.stage_ms(ctx, "connect", "sort")
