"""Reading the program's tracer (``tyrant_tpu_torch.utils.profiling``):
host spans, device stage markers a step mapped onto the host clock, and
per-step counters.

``perfbench/run.py`` profiles its window with the tracer off and hands a
reader only its Context.  So in a traced run the first reader that needs
the tracer has a pass of its own made (:func:`pass_in_child`): a fresh
process on the same card (one that has run no profiler and no
reference), which builds the cell anew with the run's own ``build`` (the
same configuration, seed and size) with the tracer on before the first
step, so that the captured graphs hold its markers and counters; warms
it up as the run does; drives the cell's traffic for
:data:`SETTLE_SECONDS`, unread (the card's first seconds under load run
slower), then for :data:`PASS_SECONDS`, as the timed window drives it,
with no profiler attached and no host spans of the benchmark's; and
hands back ``snapshot()``.  It stays on the Context (``ctx.tracer``) for
the other readers, who narrow it to the pass's window by its host-clock
interval.  Each length is at most the run's window.  Every function
returns None where the program has no tracer (no process is started
then) or the window holds nothing to read.

The pass takes the run's ``workload``, ``seed``, ``seconds``, ``device``,
``tiny`` and ``root`` from the frame of ``run.py``'s ``run`` that calls
the reader: ``run`` passes a reader nothing else.

    python3 perfbench/tracer.py '{"workload": "preset_128k.fly",
        "seed": 7, "seconds": 10, "settle": 10, "device": "cuda",
        "tiny": null, "root": "."}'

prints that pass's snapshot as the last line of standard output.
"""

from __future__ import annotations

import bisect
import functools
import gc
import json
import subprocess
import sys
import time
from pathlib import Path

SETTLE_SECONDS = 10.0
PASS_SECONDS = 10.0
CHILD_TIMEOUT_S = 400
LAUNCHERS = ("render.step.replay", "render.step.eager")


def log(*a):
    print("#", *a, file=sys.stderr, flush=True)


def traced_pass(build, camera_factory, config: dict, seed: int, device,
                tiny: dict | None, mix, seconds: float,
                settle: float = 0.0) -> dict | None:
    """The tracer's ``snapshot()`` of a pass over ``mix`` on a Renderer
    that ``build(config, seed, device, tiny)`` makes with the tracer on,
    warmed up as the run warms up its own: ``settle`` seconds, then a
    window of ``seconds``, which is ``snapshot["window"]`` ({"t_start":
    s, "seconds": s} on ``time.perf_counter``).  None where the program
    has no tracer."""
    from tyrant_tpu_torch.utils import profiling
    if not hasattr(profiling, "enable"):
        return None
    import torch

    from perfbench.drive import Driver
    t = time.perf_counter()
    profiling.enable()
    try:
        ren = build(config, seed, device, tiny)[0]
        drv = Driver(ren, mix, camera_factory())
        drv.warm_up()
        if settle > 0:
            drv.window(settle)
        w = drv.window(seconds)
        snap = profiling.snapshot()
    finally:
        profiling.disable()
    cuda = ren.device.type == "cuda"
    del drv, ren
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    snap["window"] = {"t_start": w.t_start, "seconds": w.seconds}
    log(f"tracer: a pass of {w.frames} steps in {w.seconds:.3f} s after "
        f"{settle:g} s unread ({time.perf_counter() - t:.3f} s with its "
        "set-up); device steps after their launch span:", launch_check(snap))
    return snap


def pass_in_child(workload: str, seed: int, seconds: float, device,
                  tiny: dict | None, root) -> dict | None:
    """:func:`traced_pass` of cell ``workload`` of the checkout at
    ``root``, in a process of its own (this file as a script), with the
    lengths cut to ``seconds``.  None where the program has no tracer."""
    from tyrant_tpu_torch.utils import profiling
    if not hasattr(profiling, "enable"):
        return None
    import torch
    if torch.cuda.is_available():
        torch.cuda.empty_cache()  # the run's reference is done
    args = {"workload": workload, "seed": seed,
            "seconds": min(PASS_SECONDS, seconds),
            "settle": min(SETTLE_SECONDS, seconds), "device": str(device),
            "tiny": tiny, "root": str(root)}
    proc = subprocess.run(
        [sys.executable, str(Path(__file__).resolve()), json.dumps(args)],
        cwd=root, stdout=subprocess.PIPE, text=True,
        timeout=CHILD_TIMEOUT_S)
    if proc.returncode != 0:
        raise RuntimeError(f"the tracer's pass failed ({proc.returncode})")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _run_frame():
    """The frame of ``run.py``'s ``run`` that is calling a reader."""
    f = sys._getframe(1)
    while f is not None:
        code = f.f_code
        if code.co_name == "run" and code.co_filename.endswith("run.py") \
                and "workload" in f.f_locals:
            return f
        f = f.f_back
    return None


def snapshot(ctx) -> dict | None:
    """The tracer's snapshot of the run reading ``ctx``: ``ctx.tracer``,
    taken by :func:`pass_in_child` at the first call (once a run, even
    where it is None)."""
    if not hasattr(ctx, "tracer"):
        ctx.tracer = None
        f = _run_frame()
        if f is not None:
            a = f.f_locals
            ctx.tracer = pass_in_child(a["workload"], a["seed"],
                                       a["seconds"], a["device"], a["tiny"],
                                       a["root"])
    return ctx.tracer


def _interval(snap: dict) -> tuple[float, float]:
    w = snap["window"]
    return w["t_start"] * 1e9, (w["t_start"] + w["seconds"]) * 1e9


def window_steps(ctx) -> list[dict] | None:
    """The step records whose raygen marker lies in the pass's window."""
    snap = snapshot(ctx)
    if not snap:
        return None
    a, b = _interval(snap)
    steps = [s for s in snap["steps"] if s["marks"]["raygen"] is not None
             and a <= s["marks"]["raygen"] < b]
    return steps or None


def window_spans(ctx, name: str) -> list[dict] | None:
    """The host spans ``name`` that open in the pass's window."""
    snap = snapshot(ctx)
    if not snap:
        return None
    a, b = _interval(snap)
    spans = [s for s in snap["spans"] if s["name"] == name
             and s["end_ns"] is not None and a <= s["start_ns"] < b]
    return spans or None


def _mean(values) -> float | None:
    values = list(values)
    return sum(values) / len(values) if values else None


def stage_ms(ctx, start: str, end: str) -> float | None:
    """The mean over the window's steps of the milliseconds from marker
    ``start`` to marker ``end``."""
    steps = window_steps(ctx) or []
    return _mean((s["marks"][end] - s["marks"][start]) / 1e6 for s in steps
                 if s["marks"][start] is not None
                 and s["marks"][end] is not None)


def counted(ctx, name: str) -> int | None:
    """Counter ``name`` summed over the window's steps."""
    steps = window_steps(ctx)
    return None if steps is None else sum(s["counts"][name] for s in steps)


def mean_gap_ms(ctx) -> float | None:
    """The mean, over the window's steps that follow a displayed frame on
    their device, of the milliseconds from that frame's resolve end
    marker to the step's raygen marker."""
    steps = window_steps(ctx) or []
    rows = {(s["device"], s["step"]): s for s in ctx.tracer["steps"]} \
        if steps else {}
    out = []
    for s in steps:
        prev = rows.get((s["device"], s["step"] - 1))
        if prev is not None and prev["marks"]["image_end"] is not None:
            out.append((s["marks"]["raygen"] - prev["marks"]["image_end"])
                       / 1e6)
    return _mean(out)


def launch_check(snap: dict | None) -> dict | None:
    """Whether device records mapped onto the host clock start after the
    host span that launched them (``render.step.replay`` or ``.eager``,
    matched by step index): the steps checked, those that start before
    their span, the least margin in microseconds, and the clock's
    uncertainty in microseconds, most over the devices."""
    if not snap or not snap["steps"]:
        return None
    starts = sorted((s["step"], s["start_ns"]) for s in snap["spans"]
                    if s["name"] in LAUNCHERS)
    keys = [k for k, _ in starts]
    checked = early = 0
    least = None
    for rec in snap["steps"]:
        t = rec["marks"]["raygen"]
        i = bisect.bisect_right(keys, rec["step"])
        if t is None or i == 0:
            continue
        margin = (t - starts[i - 1][1]) / 1e3
        checked += 1
        early += margin < 0
        least = margin if least is None else min(least, margin)
    return {"steps": checked, "early": early, "least_margin_us": least,
            "uncertainty_us": max((c["uncertainty_ns"] / 1e3
                                   for c in snap["clock"].values()),
                                  default=None)}


def main(argv) -> int:
    a = json.loads(argv[0])
    root = Path(a["root"]).resolve()
    if str(root) not in sys.path:
        sys.path.insert(0, str(root))
    import torch
    torch.set_num_threads(1)  # as run.py's process
    from perfbench import run
    from perfbench.drive import Mix
    manifest = run.load_manifest(root)
    cell, conf = run.find(manifest, a["workload"])
    config = json.loads((root / conf["file"]).read_text())
    mix = Mix.load(cell["traffic"], root / "perfbench" / "traffic")
    snap = traced_pass(functools.partial(run.build, root=root),
                       run.camera_factory, config, a["seed"],
                       a["device"], a["tiny"], mix, a["seconds"],
                       settle=a["settle"])
    print(json.dumps(snap), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
