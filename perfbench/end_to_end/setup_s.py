"""Seconds from the start of the process to the window's first timed step:
imports, the kernel library (built on a checkout's first run, loaded from
its cache after), the terrain, the native BVH, the device tables, the
upload, and the warm-up frames with the graph captures."""


def read(ctx):
    return ctx.setup_s
