"""Profiling helpers, the port of ``tyrant_tpu/utils/profiling.py`` (a
``torch.profiler`` trace written for Chrome or Perfetto, a synchronised
median timer, the per-stage timing of one render step), and the port's
tracer.

The tracer is off by default.  :func:`enable` turns it on,
:func:`disable` off; :func:`snapshot` returns what it recorded as plain
Python data and :func:`export_chrome` writes it as one Chrome trace.  It
records

- host spans (:func:`span`): name, start and end on ``time.perf_counter_ns``,
  the enclosing span and the index of the step the host was at
  (counted from the first step after :func:`enable`).  The
  program's are ``render.step`` (children ``render.step.reset``,
  ``.camera``, ``.replay``, ``.eager``, ``.adapt``) and ``render.image``
  (``render.image.replay`` or ``.resolve``).  Under an active
  ``torch.profiler`` session each is also a ``record_function`` range of
  the same name;
- device markers (:func:`mark`): a one-thread kernel (``csrc/common.cu``)
  writes the device clock (``%globaltimer``, ns) into a ring of
  ``ring_steps`` rows a device, one row a render step, a column a marker
  (:data:`MARKERS`: the start of each of :data:`STAGES`, the step's end,
  the display resolve's start and end; then :data:`INNER`, the markers
  inside a stage: ``fetch_end``, where the shade stage's surface fetch
  ends, which a step shaded by the base shade kernel leaves empty, and
  ``nee_end``, where the plain shade body's next-event weights end, which
  a step shaded by a shade kernel leaves empty).
  Captured into a CUDA graph, the markers record every replay with no
  host sync.  A stage
  (:func:`stage`) launches its marker and, under a profiler, is also a
  ``record_function`` range of its name, opened after the marker.  With
  the tracer off a stage is still that range under a profiler, so an
  eager step's profile splits by stage as it always did;
- per-step counters (:data:`COUNTERS`, :func:`count`): device-side int64
  sums, added after the step's end marker, kept a row a step and as
  running totals.

CPU tensors take the plain versions: the host clock instead of the
device's, the same ring arithmetic.  Device times map onto the host clock
by a linear fit of calibration pairs taken at :func:`enable` and at
:func:`snapshot` (:func:`fit_clock`); its uncertainty is half the
narrowest bracket of host clock reads around a marker.

When off, an instrumentation point costs one check of :data:`ON`, and a
stage that check and one of the profiler's switch::

    with profiling.span("name") if profiling.ON else profiling.OFF: ...
    with profiling.stage(device, k): ...
    if profiling.ON:
        profiling.mark(device, k)

Enable the tracer before a Renderer's first step: a graph captured with
the tracer off holds no markers, and one captured with it on keeps
writing its markers and counters after :func:`disable`.  The rings are
never freed, since captured graphs write into them.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import time

import torch
from torch.profiler import ProfilerActivity, profile, record_function

ON = False  # the tracer's switch: the one check an instrumentation point makes
OFF = contextlib.nullcontext()  # what an instrumentation point enters when off

STAGES = ("raygen", "extend", "shade", "connect", "sort", "accumulate")
MARKERS = STAGES + ("end", "image", "image_end")
END, IMAGE, IMAGE_END = 6, 7, 8
INNER = ("fetch_end", "nee_end")  # markers inside a stage, after MARKERS
FETCH_END, NEE_END = 9, 10
COLUMNS = MARKERS + INNER  # a step's row of the ring
CLOCK = 11  # the calibration's marker, into a buffer of its own
# shade_fused: the slots a shade kernel shaded (the queue, or 0 where
# the step took the plain shade body); tex_hits, alpha_pass, ggx_hits: the
# triangle hits that tap an albedo map, slots whose hit passed through a
# cutout or blend surface, and hits shaded as the GGX conductor, counted
# by the plain body or from the textured kernel's surface record (0 where
# the base shade kernel shaded); sphere_kernel: the slots the sphere
# kernel tested (extend's queue plus connect's, 0 where the plain test ran);
# fog_events: the segments that ended in a medium event; tri_light_picks,
# delta_light_picks: the slots whose NEE sample took the light strategy
# at a point that samples lights (DIFF, PHONG, GGX or a medium event) and
# picked a lamp triangle or a delta light; these three counted by the
# plain body alone
COUNTERS = ("fresh_rays", "tri_hits", "sphere_hits", "survivors",
            "roulette_kills", "shadow_slots", "shadow_valid", "unoccluded",
            "flushed", "shade_fused", "tex_hits", "alpha_pass", "ggx_hits",
            "sphere_kernel", "fog_events", "tri_light_picks",
            "delta_light_picks")
# a whole 51 s benchmark window at the fastest cell's rate (about 260
# steps a second), and more: 2.4 MB of markers and counters a device
RING_STEPS = 16384
CAL_TRIES = 64  # marker launches a calibration; the narrowest bracket wins

_tracer = None
_RINGS: dict = {}  # (device, ring steps) -> _Ring, for the process's life


def _device(device) -> torch.device:
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def _capturing(device: torch.device) -> bool:
    return device.type == "cuda" and torch.cuda.is_current_stream_capturing()


class _Ring:
    """A device's marker rows [slots, len(COLUMNS)], counter rows [slots,
    len(COUNTERS)] and running totals, its step counter (advanced by each
    step's end marker) and the host's count of the steps it launched."""

    def __init__(self, device: torch.device, slots: int):
        def zeros(*shape):
            return torch.zeros(shape, dtype=torch.int64, device=device)
        self.device, self.slots = device, slots
        self.marks = zeros(slots, len(COLUMNS))
        self.counts = zeros(slots, len(COUNTERS))
        self.total = zeros(len(COUNTERS))
        self.step = zeros()
        self.zero = zeros()  # a missing counter's value: no fill a step
        self.clock = zeros(1, CLOCK + 1)  # the calibration marker's row
        self.clock_step = zeros()
        self.host_steps = 0


def _launch_marker(rows, step, k: int, back: int = 0,
                   advance: bool = False) -> None:
    """Marker ``k`` into ``rows`` [slots, columns] at row (step - back) mod
    slots (marker 0 clears the rest of its row); with ``advance``, step
    += 1.  A kernel on the current stream for CUDA tensors, else the host
    clock."""
    slots, columns = rows.shape
    if rows.device.type == "cpu":
        s = int(step)
        row = rows[(s - back) % slots]
        if k == 0:
            row[1:] = 0
        row[k] = time.perf_counter_ns()
        if advance:
            step.add_(1)
        return
    from ..ops.kernels import build
    lib = build.load()
    err = lib.tyrant_trace_marker(
        k, rows.data_ptr(), step.data_ptr(), slots, columns, back,
        int(advance), torch.cuda.current_stream(rows.device).cuda_stream)
    build.check(lib, err, "tyrant_trace_marker launch")


def _launch_count(ring: _Ring, v) -> None:
    """ring.counts[(step - 1) mod slots] = v and ring.total += v."""
    if ring.device.type == "cpu":
        ring.counts[(int(ring.step) - 1) % ring.slots] = v
        ring.total.add_(v)
        return
    from ..ops.kernels import build
    lib = build.load()
    err = lib.tyrant_trace_count(
        ring.total.data_ptr(), ring.counts.data_ptr(), ring.step.data_ptr(),
        v.data_ptr(), ring.slots, v.shape[0],
        torch.cuda.current_stream(ring.device).cuda_stream)
    build.check(lib, err, "tyrant_trace_count launch")


def fit_clock(pairs) -> dict:
    """The map from device ns to host ns through calibration ``pairs``
    (host ns, device ns, half the host bracket in ns): a line through the
    first pair, its slope by least squares over the others (1 with one
    pair, the identity with none).  Plain data for :func:`to_host`."""
    if not pairs:
        return {"host_ns": 0, "device_ns": 0, "slope": 1.0,
                "uncertainty_ns": 0, "pairs": 0}
    h0, d0, _ = pairs[0]
    num = sum((d - d0) * (h - h0) for h, d, _ in pairs[1:])
    den = sum((d - d0) ** 2 for _, d, _ in pairs[1:])
    return {"host_ns": h0, "device_ns": d0,
            "slope": num / den if den else 1.0,
            "uncertainty_ns": max(u for _, _, u in pairs),
            "pairs": len(pairs)}


def to_host(clock: dict, device_ns: int) -> int:
    """``device_ns`` on the host clock (:func:`fit_clock`)."""
    return clock["host_ns"] + round(clock["slope"]
                                    * (device_ns - clock["device_ns"]))


class _Tracer:
    """What one :func:`enable` records."""

    def __init__(self, ring_steps: int):
        self.ring_steps = ring_steps
        self.spans: list = []  # [name, start ns, end ns, parent, step]
        self.stack: list = []  # the open spans' indices
        self.rings: dict = {}  # key -> (ring, first step, totals then)
        self.pairs: dict = {}  # key -> calibration pairs
        self.last: str | None = None  # the device of the last marker
        self.deferred: dict = {}  # counter -> fn, left by the stages

    def ring(self, device) -> _Ring:
        d = _device(device)
        key = str(d)
        if key in self.rings:
            return self.rings[key][0]
        if _capturing(d):
            raise RuntimeError(
                f"the tracer meets {key} first inside a CUDA graph capture: "
                "enable it before the Renderer's first step")
        r = _RINGS.get((key, self.ring_steps))
        if r is None:
            r = _RINGS[(key, self.ring_steps)] = _Ring(d, self.ring_steps)
        r.host_steps = int(r.step)  # a graph may have run untracked
        self.rings[key] = (r, r.host_steps, r.total.clone())
        return r

    def step_index(self) -> int:
        """The index, since :func:`enable`, of the step the host is at on
        the device of the last marker (0 before the first)."""
        if self.last is None:
            return 0
        r, first, _ = self.rings[self.last]
        return r.host_steps - first

    def calibrate(self, r: _Ring) -> None:
        """One more pair (host ns, device ns, half bracket) for a CUDA
        ring: the narrowest of CAL_TRIES host brackets around a marker
        launch and a synchronise, the launch's arguments made before."""
        if r.device.type != "cuda":
            return
        from ..ops.kernels import build
        lib = build.load()
        args = (CLOCK, r.clock.data_ptr(), r.clock_step.data_ptr(), 1,
                CLOCK + 1, 0, 0,
                torch.cuda.current_stream(r.device).cuda_stream)
        sync = torch.cuda.current_stream(r.device).synchronize
        best = None
        for _ in range(CAL_TRIES):
            sync()
            t0 = time.perf_counter_ns()
            err = lib.tyrant_trace_marker(*args)
            sync()
            t1 = time.perf_counter_ns()
            build.check(lib, err, "tyrant_trace_marker launch")
            if best is None or t1 - t0 < best[1] - best[0]:
                best = (t0, t1, int(r.clock[0, CLOCK]))
        t0, t1, dev_ns = best
        self.pairs.setdefault(str(r.device), []).append(
            ((t0 + t1) // 2, dev_ns, (t1 - t0 + 1) // 2))


class _Span:
    __slots__ = ("tracer", "name", "index", "range")

    def __init__(self, name: str):
        self.tracer, self.name, self.range = _tracer, name, None

    def __enter__(self):
        t = self.tracer
        self.index = len(t.spans)
        t.spans.append([self.name, time.perf_counter_ns(), None,
                        t.stack[-1] if t.stack else None,
                        t.step_index()])
        t.stack.append(self.index)
        if torch.autograd._profiler_enabled():
            self.range = record_function(self.name)
            self.range.__enter__()
        return self

    def __exit__(self, *exc):
        if self.range is not None:
            self.range.__exit__(*exc)
        t = self.tracer
        t.spans[self.index][2] = time.perf_counter_ns()
        t.stack.pop()
        return False


def enable(ring_steps: int = RING_STEPS) -> None:
    """Start recording anew (what an earlier :func:`enable` recorded is
    dropped), with rings of ``ring_steps`` steps a device; with CUDA, the
    current device's ring is made and the clock calibrated."""
    global _tracer, ON
    if ring_steps < 1:
        raise ValueError(f"ring_steps must be positive, got {ring_steps}")
    _tracer = _Tracer(ring_steps)
    if torch.cuda.is_available():
        r = _tracer.ring(torch.cuda.current_device())
        _tracer.calibrate(r)
        _tracer.last = str(r.device)
    ON = True


def disable() -> None:
    """Stop recording; :func:`snapshot` still returns what was recorded."""
    global ON
    ON = False


def span(name: str) -> _Span:
    """A host span ``name`` (a context manager).  Call only when ON."""
    return _Span(name)


def mark(device, k: int) -> None:
    """Marker ``k`` of :data:`COLUMNS` on ``device``'s current stream:
    marker 0 opens the step's row, :data:`END` advances the step, the
    image markers go into the row of the step last ended.  Call only when
    ON."""
    t = _tracer
    r = t.ring(device)
    if k == 0:
        t.deferred.clear()
    _launch_marker(r.marks, r.step, k, back=int(k in (IMAGE, IMAGE_END)),
                   advance=k == END)
    t.last = str(r.device)
    if k == END and not _capturing(r.device):
        r.host_steps += 1


def stage(device, k: int):
    """Stage ``k`` of :data:`STAGES` (a context manager): with the tracer
    on, its marker, then, under a profiler, a ``record_function`` range of
    its name around the enclosed code; with it off, the range alone under
    a profiler, and nothing without one."""
    if ON:
        return _marked_stage(device, k)
    if torch.autograd._profiler_enabled():
        return record_function(STAGES[k])
    return OFF


@contextlib.contextmanager
def _marked_stage(device, k: int):
    mark(device, k)
    if torch.autograd._profiler_enabled():
        with record_function(STAGES[k]):
            yield
    else:
        yield


def replayed(device, steps: int = 1) -> None:
    """The host's count of ``device``'s steps after a replay of a graph
    that holds ``steps`` traced steps.  Call only when ON."""
    _tracer.ring(device).host_steps += steps


def defer(counter: str, fn) -> None:
    """``fn()`` gives ``counter``'s value for this step, computed by
    :func:`count` after the step's end marker.  Call only when ON."""
    _tracer.deferred[counter] = fn


def defer_add(counter: str, n: int) -> None:
    """Add ``n`` to ``counter``'s value for this step: the calls of a step
    sum.  Call only when ON."""
    prev = _tracer.deferred.get(counter)
    _tracer.deferred[counter] = (lambda: n) if prev is None \
        else (lambda: prev() + n)


def count(device, **values) -> None:
    """Add this step's counters (tensors or ints, by the names of
    :data:`COUNTERS`, with the deferred ones; a missing one counts 0) to
    ``device``'s ring row and running totals.  Call only when ON, after
    the step's end marker."""
    t = _tracer
    values.update((k, fn()) for k, fn in t.deferred.items())
    t.deferred.clear()
    r = t.ring(device)
    v = torch.stack([
        x.to(torch.int64) if isinstance(x, torch.Tensor)
        else r.zero if x == 0
        else torch.full((), x, dtype=torch.int64, device=r.device)
        for x in (values.get(c, 0) for c in COUNTERS)])
    _launch_count(r, v)


def snapshot() -> dict | None:
    """What the tracer recorded since :func:`enable` (None before the
    first), as plain Python data, after a synchronise and one more clock
    calibration of each CUDA device:

    - ``spans``: [{"name", "start_ns", "end_ns", "parent" (an index into
      ``spans`` or None), "step"}] in the order they opened;
    - ``steps``: [{"device", "step", "marks": {marker of
      :data:`COLUMNS`: host ns or None},
      "counts": {counter: int}}] for each step whose row the ring still
      holds, oldest first; device times are mapped onto the host clock;
      a step's index counts from the first after :func:`enable` on its
      device, as a span's does;
    - ``counters``: {device: {counter: total since enable}};
    - ``clock``: {device: :func:`fit_clock`'s map}."""
    t = _tracer
    if t is None:
        return None
    out = {"spans": [dict(zip(("name", "start_ns", "end_ns", "parent",
                               "step"), s)) for s in t.spans],
           "steps": [], "counters": {}, "clock": {}}
    for key, (r, first, total0) in t.rings.items():
        if r.device.type == "cuda":
            torch.cuda.synchronize(r.device)
            t.calibrate(r)
        clock = out["clock"][key] = fit_clock(t.pairs.get(key, []))
        last = int(r.step)
        marks, counts = r.marks.cpu().tolist(), r.counts.cpu().tolist()
        for s in range(max(first, last - r.slots), last):
            row = s % r.slots
            out["steps"].append({
                "device": key, "step": s - first,
                "marks": {m: (to_host(clock, v) if v else None)
                          for m, v in zip(COLUMNS, marks[row])},
                "counts": dict(zip(COUNTERS, counts[row]))})
        out["counters"][key] = dict(zip(
            COUNTERS, (r.total - total0.to(r.device)).cpu().tolist()))
    return out


def _chrome_events(snap: dict) -> list[dict]:
    """A :func:`snapshot` as Chrome trace events (microseconds on the host
    clock): host spans on one track; each device's stages, from a marker
    to the next, its display resolves, its shade stages' surface fetches
    (``shade`` to ``fetch_end``) and the plain body's next-event samples
    and weights (``fetch_end`` to ``nee_end``) on four more; its counters,
    a point at each step's end."""
    ev = [{"ph": "M", "name": "process_name", "pid": "host",
           "args": {"name": "host"}}]
    for i, s in enumerate(snap["spans"]):
        if s["end_ns"] is None:
            continue
        ev.append({"ph": "X", "cat": "span", "name": s["name"], "pid": "host",
                   "tid": "spans", "ts": s["start_ns"] / 1e3,
                   "dur": (s["end_ns"] - s["start_ns"]) / 1e3,
                   "args": {"step": s["step"], "parent": s["parent"],
                            "index": i}})
    for rec in snap["steps"]:
        pid, m = f"device {rec['device']}", rec["marks"]
        for name, a, b in [*zip(STAGES, MARKERS[:END], MARKERS[1:END + 1]),
                           ("image", "image", "image_end"),
                           ("surface_fetch", "shade", "fetch_end"),
                           ("nee", "fetch_end", "nee_end")]:
            if m[a] is not None and m[b] is not None:
                ev.append({"ph": "X", "cat": "stage", "name": name,
                           "pid": pid,
                           "tid": name if name in ("image", "surface_fetch",
                                                   "nee")
                           else "step",
                           "ts": m[a] / 1e3, "dur": (m[b] - m[a]) / 1e3,
                           "args": {"step": rec["step"]}})
        if m["end"] is not None:
            ev.append({"ph": "C", "name": "counters", "pid": pid,
                       "ts": m["end"] / 1e3, "args": rec["counts"]})
    return ev


def export_chrome(path: str) -> str:
    """Write :func:`snapshot` as a Chrome trace (``chrome://tracing`` and
    Perfetto open it) to ``path``; returns ``path``."""
    snap = snapshot()
    if snap is None:
        raise RuntimeError("the tracer was never enabled")
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        json.dump({"traceEvents": _chrome_events(snap),
                   "otherData": {"clock": snap["clock"],
                                 "counters": snap["counters"]}}, f)
    return path


@contextlib.contextmanager
def trace(log_dir: str = "build/tyrant_trace"):
    """Profile the enclosed code (the host and, when CUDA is there, the
    device) and write ``log_dir/trace.json``, a Chrome trace that
    ``chrome://tracing`` and Perfetto open.  Yields ``log_dir``."""
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield log_dir
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def _cuda_device(out):
    """The CUDA device of the first CUDA tensor in ``out`` (a tensor, or
    tuples, lists, dicts and dataclasses of them), else None."""
    if isinstance(out, torch.Tensor):
        return out.device if out.is_cuda else None
    if dataclasses.is_dataclass(out) and not isinstance(out, type):
        out = [getattr(out, f.name) for f in dataclasses.fields(out)]
    elif isinstance(out, dict):
        out = list(out.values())
    if isinstance(out, (tuple, list)):
        for x in out:
            dev = _cuda_device(x)
            if dev is not None:
                return dev
    return None


def time_blocked(fn, *args, reps: int = 3, warmup: int = 1, **kw):
    """(median seconds of ``fn(*args, **kw)``, its last output).  When the
    output holds a CUDA tensor, each call is timed by CUDA events on its
    device's current stream, recorded around it, and waited for; otherwise
    by the host clock."""
    out = None
    for _ in range(max(warmup, 1)):
        out = fn(*args, **kw)
    dev = _cuda_device(out)
    if dev is not None:
        torch.cuda.synchronize(dev)
    times = []
    for _ in range(reps):
        if dev is None:
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            times.append(time.perf_counter() - t0)
            continue
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record(torch.cuda.current_stream(dev))
        out = fn(*args, **kw)
        end.record(torch.cuda.current_stream(dev))
        end.synchronize()
        times.append(start.elapsed_time(end) * 1e-3)
    times.sort()
    return times[len(times) // 2], out


def stage_profile(renderer, camera, n_steps: int = 5) -> dict:
    """Median ms of each stage of one wavefront step at ``camera``'s pose
    (raygen, extend, shade, connect, each fed the one before) and of a
    whole :func:`~tyrant_tpu_torch.render.render_step`, each over
    ``n_steps`` calls.  Every stage reads a copy of ``renderer.state``, so
    the renderer's own state does not advance."""
    from ..render import (RenderState, _connect, _intersect_scene,
                          _pick_wave, _raygen, _salted_frame, _shade,
                          merge_queue, render_step)

    cfg = renderer.cfg
    cam = camera.to_device(cfg, renderer.device)
    state = RenderState(**{f.name: getattr(renderer.state, f.name).clone()
                           for f in dataclasses.fields(RenderState)})
    scene, tables = renderer.scene, renderer.tables
    perm = state.pixel_perm if cfg.adaptive_sampling == "on" else None
    frame = _salted_frame(cfg, state.frame)

    t_raygen, _ = time_blocked(
        lambda: _raygen(cfg, cam, state.start_position, frame, perm=perm,
                        sample_base=state.sample_base), reps=n_steps)
    rays = merge_queue(cfg, state, cam)
    t_extend, ext = time_blocked(
        lambda: _intersect_scene(rays["origin"], rays["direction"], scene,
                                 tables, wave=_pick_wave(cfg)),
        reps=n_steps)
    t_shade, sh = time_blocked(
        lambda: _shade(cfg, scene, renderer.sky_params, renderer.sun_dir,
                       rays, *ext, frame), reps=n_steps)
    t_connect, _ = time_blocked(
        lambda: _connect(scene, sh[3], tables,
                         wave=_pick_wave(cfg)), reps=n_steps)
    t_full, _ = time_blocked(
        lambda: render_step(state, scene, cam, renderer.sun_dir, cfg=cfg,
                            tables=tables, sky_params=renderer.sky_params),
        reps=n_steps)

    total = t_raygen + t_extend + t_shade + t_connect
    return {
        "raygen_ms": t_raygen * 1e3,
        "extend_ms": t_extend * 1e3,
        "shade_ms": t_shade * 1e3,
        "connect_ms": t_connect * 1e3,
        "stage_sum_ms": total * 1e3,
        "full_step_ms": t_full * 1e3,
        "mrays_per_s_segments": cfg.num_rays / t_full / 1e6,
    }
