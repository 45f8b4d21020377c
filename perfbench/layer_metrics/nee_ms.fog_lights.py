"""Milliseconds a step of the plain shade body's next-event estimation
inside the replayed step (the sun cone, the coin, the light pick by its
alias row, the sphere, lamp or delta light sample, the DIFF, PHONG and
phase estimators and the fog's transmittance on every shadow ray): from
the ``fetch_end`` device marker to ``nee_end``, the mean over the window
of the tracer's pass (``perfbench/tracer.py``).  None where the program
has no ``nee_end`` marker, or no step of the window recorded it (a shade
kernel shaded)."""

from perfbench import tracer


def read(ctx):
    steps = tracer.window_steps(ctx)
    if not steps or any(s["marks"].get("nee_end") is None for s in steps):
        return None
    return tracer.stage_ms(ctx, "fetch_end", "nee_end")
