"""Milliseconds a step of the ``sort`` stage (the compaction sort and its
gathers) inside the replayed step: from its device marker to
``accumulate``'s, the mean over the window of the tracer's pass
(``perfbench/tracer.py``)."""

from perfbench import tracer


def read(ctx):
    return tracer.stage_ms(ctx, "sort", "accumulate")
