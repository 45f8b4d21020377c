"""Host milliseconds of the step graph's launch: the program's
``render.step.replay`` span (``graph.replay()`` alone, inside
``Renderer.step``), the mean over the frames of the tracer's pass
(``perfbench/tracer.py``)."""

from perfbench import tracer


def read(ctx):
    spans = tracer.window_spans(ctx, "render.step.replay")
    if spans is None:
        return None
    return sum(s["end_ns"] - s["start_ns"] for s in spans) / len(spans) / 1e6
