"""The share of the queue slots that the shade kernel shaded, over the
window of the tracer's pass (``perfbench/tracer.py``), in percent: the
program's per-step counter ``shade_fused`` (the slots of a step that the
fused shade kernel took, 0 where the step ran the plain shade body) over
``shadow_slots`` (every queue slot).  None where the program has no such
counter."""

from perfbench import tracer


def read(ctx):
    steps = tracer.window_steps(ctx)
    if not steps or any("shade_fused" not in s["counts"] for s in steps):
        return None
    slots = sum(s["counts"]["shadow_slots"] for s in steps)
    if not slots:
        return None
    return 100.0 * sum(s["counts"]["shade_fused"] for s in steps) / slots
