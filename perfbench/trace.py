"""Reading a ``torch.profiler`` trace (its Chrome JSON export): the device
records (kernels, copies, memsets, whether launched alone or by a CUDA
graph replay), the benchmark's annotated windows, the union of busy
intervals inside them, the idle gaps named by what the host was doing,
and the device time of the operations launched inside a named range.

Times in the export are microseconds on one clock for host and device.
"""

from __future__ import annotations

import json
from pathlib import Path

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("user_annotation", "cpu_op", "cuda_runtime", "cuda_driver")
WINDOW = "perfbench.window"


def union(intervals) -> list[tuple[float, float]]:
    """The union of [start, end) intervals, as sorted disjoint ones."""
    out: list[list[float]] = []
    for s, e in sorted(intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def clip(intervals, windows) -> list[tuple[float, float]]:
    """The parts of disjoint sorted ``intervals`` inside the windows."""
    out = []
    for ws, we in windows:
        for s, e in intervals:
            s2, e2 = max(s, ws), min(e, we)
            if s2 < e2:
                out.append((s2, e2))
    return out


def length(intervals) -> float:
    return sum(e - s for s, e in intervals)


class Trace:
    """One exported trace."""

    def __init__(self, events: list[dict]):
        x = [e for e in events if e.get("ph") == "X" and "dur" in e]
        self.device = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                        e.get("name", ""), e.get("args", {}).get("correlation"))
                       for e in x if e.get("cat") in DEVICE_CATS]
        self.host = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                      e.get("name", ""), e.get("cat"), e.get("tid"),
                      e.get("args", {}).get("correlation"))
                     for e in x if e.get("cat") in HOST_CATS]

    @classmethod
    def load(cls, path: Path) -> "Trace":
        with open(path) as f:
            data = json.load(f)
        return cls(data["traceEvents"] if isinstance(data, dict) else data)

    def ranges(self, name: str) -> list[tuple[float, float]]:
        """The host intervals of every annotation ``name``."""
        return sorted((s, e) for s, e, n, cat, _, _ in self.host
                      if cat == "user_annotation" and n == name)

    def windows(self) -> list[tuple[float, float]]:
        """The traced windows: for each ``perfbench.window`` annotation,
        the device span of the operations launched inside it, from the
        first one's start to the last one's end (the host's way into the
        window and its closing synchronise are left out)."""
        out = []
        for r in self.ranges(WINDOW):
            ops = self.launched([r])
            if ops:
                out.append((min(s for s, _ in ops), max(e for _, e in ops)))
        return out

    def _launch_ids(self, spans) -> set:
        return {corr for s, _, _, cat, _, corr in self.host
                if cat in ("cuda_runtime", "cuda_driver")
                and corr is not None and any(a <= s < b for a, b in spans)}

    def launched(self, spans) -> list[tuple[float, float]]:
        """The device intervals of the operations launched inside the host
        ``spans`` (matched by correlation id through the runtime call that
        launched them; a graph replay's kernels share its id)."""
        ids = self._launch_ids(spans)
        return [(s, e) for s, e, _, corr in self.device if corr in ids]

    def busy(self, windows=None) -> list[tuple[float, float]]:
        """The union of device intervals, inside ``windows`` when given."""
        u = union((s, e) for s, e, _, _ in self.device)
        return u if windows is None else clip(u, windows)

    def idle_pct(self, windows) -> float | None:
        """1 - the union of busy intervals over the windows' length, in
        percent (None without a window or any device work)."""
        window, busy = length(windows), length(self.busy(windows))
        return 100.0 * (1.0 - busy / window) if window > 0 and busy > 0 \
            else None

    def device_time(self, windows, match) -> float:
        """Summed device microseconds of the records inside the windows
        whose name contains one of ``match``."""
        return sum(length(clip([(s, e)], windows))
                   for s, e, name, _ in self.device
                   if any(m in name for m in match))

    def by_name(self, windows) -> dict[str, float]:
        out: dict[str, float] = {}
        for s, e, name, _ in self.device:
            d = length(clip([(s, e)], windows))
            if d > 0:
                out[name] = out.get(name, 0.0) + d
        return out

    def gaps(self, windows) -> list[tuple[float, float]]:
        """The idle intervals inside the windows."""
        out = []
        busy = self.busy()
        for ws, we in windows:
            t = ws
            for s, e in busy:
                if e <= ws or s >= we:
                    continue
                if s > t:
                    out.append((t, s))
                t = max(t, e)
            if t < we:
                out.append((t, we))
        return out

    def host_at(self, t: float) -> str:
        """The innermost host record open at ``t`` (the shortest that
        covers it), or "host idle"."""
        best = None
        for s, e, name, *_ in self.host:
            if s <= t < e and (best is None or e - s < best[1] - best[0]):
                best = (s, e, name)
        return best[2] if best else "host idle"

    def launched_in(self, name: str) -> float:
        """Device microseconds of the operations launched inside the host
        ranges called ``name`` that lie in a ``perfbench.window``
        annotation."""
        spans = clip(self.ranges(name), self.ranges(WINDOW))
        return length(union(self.launched(spans)))


def breakdown(trace: Trace, windows, top: int = 10) -> dict:
    """The device operations that took most time and the longest idle
    gaps, named by what the host was doing, in seconds."""
    ops = sorted(trace.by_name(windows).items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(trace.gaps(windows), key=lambda g: g[0] - g[1])[:top]
    return {"device_ops": [[n[:160], d * 1e-6] for n, d in ops],
            "idle_gaps": [[trace.host_at(s)[:160], (e - s) * 1e-6]
                          for s, e in gaps]}
