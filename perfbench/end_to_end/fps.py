"""Displayed frames completed in the window over its wall time."""


def read(ctx):
    w = ctx.window
    if not w.frame_s or w.seconds <= 0.0:
        return None
    return len(w.frame_s) / w.seconds
