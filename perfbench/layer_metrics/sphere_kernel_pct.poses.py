"""The share of the ray-sphere tests that the sphere kernel made, over
the window of the tracer's pass (``perfbench/tracer.py``), in percent:
the program's per-step counter ``sphere_kernel`` (the slots the sphere
kernel tested in a step: extend's queue plus connect's, 0 where the step
ran the plain sphere test) over twice ``shadow_slots`` (every queue slot,
tested once in each stage).  None where the program has no such
counter."""

from perfbench import tracer


def read(ctx):
    steps = tracer.window_steps(ctx)
    if not steps or any("sphere_kernel" not in s["counts"] for s in steps):
        return None
    slots = sum(s["counts"]["shadow_slots"] for s in steps)
    if not slots:
        return None
    return 100.0 * sum(s["counts"]["sphere_kernel"] for s in steps) \
        / (2 * slots)
