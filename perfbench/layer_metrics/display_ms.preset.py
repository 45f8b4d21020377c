"""Milliseconds a displayed frame spends in ``Renderer.image(uint8=True)``
and the copy of its pixels to host memory (the viewer's path): the
benchmark's host span, the mean over the window's frames.
``display_ms.fly`` of the interactive preset, where it moves
``frame_ms_p95.preset``."""


def read(ctx):
    return ctx.window.mean_span_ms("display")
