"""Render metrics and structured logging, the port of
``tyrant_tpu/utils/metrics.py``: a counter and timer registry that emits
JSON lines, and the wavefront-occupancy stats of a render state."""

from __future__ import annotations

import json
import sys
import time
from collections import defaultdict


class Metrics:
    def __init__(self, sink=None):
        self.counters = defaultdict(float)
        self.timings = defaultdict(list)
        self.sink = sink or sys.stderr

    def count(self, name: str, value: float = 1.0):
        self.counters[name] += value

    def time(self, name: str):
        return _Timer(self, name)

    def observe(self, name: str, seconds: float):
        self.timings[name].append(seconds)

    def snapshot(self) -> dict:
        out = dict(self.counters)
        for name, vals in self.timings.items():
            if not vals:
                continue
            out[f"{name}_ms_avg"] = 1e3 * sum(vals) / len(vals)
            out[f"{name}_ms_min"] = 1e3 * min(vals)
            out[f"{name}_ms_max"] = 1e3 * max(vals)
            out[f"{name}_count"] = len(vals)
        return out

    def emit(self, **extra):
        rec = {"ts": time.time(), **self.snapshot(), **extra}
        print(json.dumps(rec), file=self.sink, flush=True)
        return rec


class _Timer:
    def __init__(self, metrics: Metrics, name: str):
        self.metrics = metrics
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.metrics.observe(self.name, time.perf_counter() - self.t0)


def render_stats(state, cfg) -> dict:
    """Wavefront occupancy of a ``RenderState``: the frame counter, the
    carried rays and their share of the queue, and the completed paths a
    pixel (mean and least).  Reads the state back to the host."""
    paths = state.accum[:, 3].cpu().numpy()
    return {
        "frame": int(state.frame),
        "carried_rays": int(state.n_carried),
        "carry_fraction": float(int(state.n_carried)) / cfg.num_rays,
        "paths_per_pixel_mean": float(paths.mean()),
        "paths_per_pixel_min": float(paths.min()),
    }
