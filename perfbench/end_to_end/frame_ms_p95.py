"""The 95th percentile of every displayed frame of the window, each from
the camera's move to its 8-bit pixels in host memory, in milliseconds
(linear interpolation between the two nearest frames)."""

import numpy as np


def read(ctx):
    w = ctx.window
    if not w.frame_s:
        return None
    return float(np.percentile(np.asarray(w.frame_s) * 1e3, 95))
