"""Milliseconds a step of the shade stage's surface fetch inside the
replayed step (the tri_shade and tri_attr rows, the uv and tangent frame,
and the albedo, normal and roughness/metal map taps of the plain shade
body): from the ``shade`` device marker to ``fetch_end``, the mean over
the window of the tracer's pass (``perfbench/tracer.py``).  None where
the program has no ``fetch_end`` marker, or no step of the window
recorded it (the shade kernel shaded)."""

from perfbench import tracer


def read(ctx):
    steps = tracer.window_steps(ctx)
    if not steps or any("fetch_end" not in s["marks"] for s in steps):
        return None
    return tracer.stage_ms(ctx, "shade", "fetch_end")
