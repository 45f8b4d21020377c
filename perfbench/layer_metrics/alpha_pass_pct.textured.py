"""The share of the queue slots spent on a pass-through, over the window
of the tracer's pass (``perfbench/tracer.py``), in percent: the
program's per-step counter ``alpha_pass`` (the slots whose hit lay on a
cutout below its alpha threshold or a blend surface that its coin let
through: a segment traced and shaded that adds nothing) over
``shadow_slots`` (every queue slot).  An any-hit cutout test inside the
traversal would lower it.  None where the program has no such counter."""

from perfbench import tracer


def read(ctx):
    steps = tracer.window_steps(ctx)
    if not steps or any("alpha_pass" not in s["counts"] for s in steps):
        return None
    slots = sum(s["counts"]["shadow_slots"] for s in steps)
    if not slots:
        return None
    return 100.0 * sum(s["counts"]["alpha_pass"] for s in steps) / slots
