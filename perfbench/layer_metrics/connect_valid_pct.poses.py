"""The share of connect's launched shadow slots that carry a valid shadow
ray, over the window of the tracer's pass (``perfbench/tracer.py``), in
percent: the program's per-step counters ``shadow_valid`` (the sum
``RenderState.shadow_rays`` adds) over ``shadow_slots`` (every queue slot
goes to the any-hit kernel)."""

from perfbench import tracer


def read(ctx):
    slots = tracer.counted(ctx, "shadow_slots")
    if not slots:
        return None
    return 100.0 * tracer.counted(ctx, "shadow_valid") / slots
