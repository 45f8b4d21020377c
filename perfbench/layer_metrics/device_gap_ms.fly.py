"""Device milliseconds between frames with no profiler attached: from the
previous frame's resolve end marker to this frame's raygen marker (the
copy out, the host's turn, the reset and camera upload, the launch), the
mean over the frames of the tracer's pass (``perfbench/tracer.py``)."""

from perfbench import tracer


def read(ctx):
    return tracer.mean_gap_ms(ctx)
