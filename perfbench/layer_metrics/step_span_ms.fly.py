"""Milliseconds a displayed frame spends in ``Renderer.step`` as the frame
loop calls it: the benchmark's host span around the step and a device
synchronise after it, the mean over the window's frames."""


def read(ctx):
    return ctx.window.mean_span_ms("step")
