"""Offline throughput, the repo's metric of record: every path segment of
the window (the whole ray queue each step, one step a frame) plus every
valid NEE shadow ray traced in it, over the window's wall time, in
millions a second.  The arithmetic of
``tyrant_tpu_torch/bench/poses.py:mrays_per_s``, taken over all the
window's work and time."""


def read(ctx):
    w = ctx.window
    if w.frames == 0 or w.seconds <= 0.0:
        return None
    segments = w.frames * ctx.render["num_rays"]
    return (segments + w.shadow_rays) / w.seconds / 1e6
