"""The share of the queue slots whose segment ended in a fog medium
event, over the window of the tracer's pass (``perfbench/tracer.py``), in
percent: the program's per-step counter ``fog_events`` (the segments
whose free-flight draw collided before the surface) over
``shadow_slots`` (every queue slot).  None where the program has no such
counter."""

from perfbench import tracer


def read(ctx):
    steps = tracer.window_steps(ctx)
    if not steps or any("fog_events" not in s["counts"] for s in steps):
        return None
    slots = sum(s["counts"]["shadow_slots"] for s in steps)
    if not slots:
        return None
    return 100.0 * sum(s["counts"]["fog_events"] for s in steps) / slots
