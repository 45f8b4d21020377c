"""The traversal kernels' share of their roofline in the captured step:
the least time of a step's traversal work (``roofline.traversal_work``:
the extend queue, the valid shadow rays and the triangles read once per
queue, counted from the inputs) over the summed device time a step of the
kernels named below, in percent of the H100's peaks."""

from perfbench import roofline

KERNELS = ("traverse_kernel", "traverse_wave_kernel")


def read(ctx):
    if ctx.trace is None or not ctx.profiled_steps:
        return None
    us = ctx.trace.device_time(ctx.windows, KERNELS) / ctx.profiled_steps
    if us <= 0:
        return None
    shadow = ctx.profiled_shadow_rays / ctx.profiled_steps
    least = roofline.least_seconds(*roofline.traversal_work(
        ctx.render["num_rays"], shadow, ctx.triangles))
    return 100.0 * least / (us * 1e-6)
