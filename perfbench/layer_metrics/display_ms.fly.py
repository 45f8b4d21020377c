"""Milliseconds a displayed frame spends in ``Renderer.image(uint8=True)``
and the copy of its pixels to host memory (the viewer's path): the
benchmark's host span, the mean over the window's frames."""


def read(ctx):
    return ctx.window.mean_span_ms("display")
