"""Milliseconds a step of the shade stage after its surface fetch inside
the replayed step (the cutout and blend decision, NEE, the bounce with
its GGX lobe, roulette and the sky): from the ``fetch_end`` device marker
to ``connect``'s, the mean over the window of the tracer's pass
(``perfbench/tracer.py``).  None where the program has no ``fetch_end``
marker, or no step of the window recorded it."""

from perfbench import tracer


def read(ctx):
    steps = tracer.window_steps(ctx)
    if not steps or any("fetch_end" not in s["marks"] for s in steps):
        return None
    return tracer.stage_ms(ctx, "fetch_end", "connect")
