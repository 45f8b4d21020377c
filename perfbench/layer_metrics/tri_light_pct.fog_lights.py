"""The share of the queue slots whose NEE sample went to a lamp triangle,
over the window of the tracer's pass (``perfbench/tracer.py``), in
percent: the program's per-step counter ``tri_light_picks`` (the slots
that took the light strategy at a point that samples lights and picked
an emissive triangle) over ``shadow_slots`` (every queue slot).  None
where the program has no such counter."""

from perfbench import tracer


def read(ctx):
    steps = tracer.window_steps(ctx)
    if not steps or any("tri_light_picks" not in s["counts"] for s in steps):
        return None
    slots = sum(s["counts"]["shadow_slots"] for s in steps)
    if not slots:
        return None
    return 100.0 * sum(s["counts"]["tri_light_picks"] for s in steps) / slots
