"""Milliseconds a step of the ``shade`` stage inside the replayed step:
from its device marker to ``connect``'s, the mean over the window of the
tracer's pass (``perfbench/tracer.py``).  ``shade_device_ms.poses``
reads the same stage from an eager profiled pass at pose 0."""

from perfbench import tracer


def read(ctx):
    return tracer.stage_ms(ctx, "shade", "connect")
