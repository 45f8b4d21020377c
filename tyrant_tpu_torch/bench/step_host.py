"""The eager render step's host side on the card.

The main cell (``benchmark_scene(1_048_576)``, ``RenderConfig()`` with
``fuse_step_chains="off"``) under "mono" and "wave", at each pose: 4
warm-up steps, then ``STEPS`` steps timed by the host's clock, with
CUDA events around the same window (they span the host's gaps too), the
CPU time of the dispatching thread and of the whole process, and the
hypervisor's steal share of the machine's CPU time (``/proc/stat``);
then 2 steps under
cProfile: Python calls a step and the functions with the most own time.
An eager step is host-bound when its thread's CPU time a step comes
close to its wall time; a wall time above both, at equal calls, is time
the thread did not get a core.

Prints a line a run, and one JSON line of all details (to ``--out`` when
given, else to standard output).  Run from a tree's root::

    python -m tyrant_tpu_torch.bench.step_host --out build/step_host.json

To compare two trees, copy this file into the other tree's
``tyrant_tpu_torch/bench/`` and run both in alternating order in one call.
"""

from __future__ import annotations

import argparse
import cProfile
import dataclasses
import json
import os
import pstats
import subprocess
import time

import torch

from .. import render as tr
from ..config import RenderConfig
from ..scene.procgen import benchmark_scene
from ..scene.scene import Scene
from .poses import camera_for_pose

STEPS = 20
PROFILED_STEPS = 2
TOP = 12


def cpu_jiffies() -> tuple[int, int]:
    """(steal, total) jiffies of all CPUs so far, from /proc/stat."""
    with open("/proc/stat") as f:
        fields = [int(v) for v in f.readline().split()[1:]]
    return fields[7], sum(fields[:8])


def timed_steps(ren, cam, steps: int) -> dict:
    """``steps`` steps: wall, CUDA-event, thread and process CPU ms a step
    and the steal share of the window."""
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    s0, j0 = cpu_jiffies()
    w0, t0, p0 = time.perf_counter(), time.thread_time(), time.process_time()
    a.record()
    ren.step(cam, steps)
    b.record()
    torch.cuda.synchronize()
    w1, t1, p1 = time.perf_counter(), time.thread_time(), time.process_time()
    s1, j1 = cpu_jiffies()
    return dict(wall_ms=(w1 - w0) * 1e3 / steps,
                events_ms=a.elapsed_time(b) / steps,
                thread_cpu_ms=(t1 - t0) * 1e3 / steps,
                process_cpu_ms=(p1 - p0) * 1e3 / steps,
                steal_share=(s1 - s0) / max(j1 - j0, 1))


def profiled_steps(ren, cam) -> dict:
    """Python calls a step and the ``TOP`` functions by own time under
    cProfile (ms a step, calls a step)."""
    prof = cProfile.Profile()
    torch.cuda.synchronize()
    prof.enable()
    ren.step(cam, PROFILED_STEPS)
    torch.cuda.synchronize()
    prof.disable()
    st = pstats.Stats(prof)
    rows = sorted(st.stats.items(), key=lambda kv: -kv[1][2])[:TOP]
    return dict(calls=st.total_calls / PROFILED_STEPS,
                top=[dict(fn=f"{os.path.basename(k[0])}:{k[1]}:{k[2]}",
                          own_ms=v[2] * 1e3 / PROFILED_STEPS,
                          calls=v[1] / PROFILED_STEPS)
                     for k, v in rows])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("step_host: CUDA is not available")
        return 2
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(gpu, flush=True)
    sd = Scene.from_triangles(*benchmark_scene(1_048_576)).to_device("cuda")
    cfg = RenderConfig(fuse_step_chains="off")
    out = dict(gpu=gpu, cpus=len(os.sched_getaffinity(0)),
               threads=torch.get_num_threads(), runs=[])
    ren = None
    for mode in ("mono", "wave"):
        ren = tr.Renderer(sd, dataclasses.replace(cfg,
                                                  packet_kernel_mode=mode),
                          tables=None if ren is None else ren.tables)
        for i in (0, 1, 2):
            cam = camera_for_pose(i)
            ren.step(cam, 4)
            run = dict(mode=mode, pose=i, **timed_steps(ren, cam, STEPS))
            run.update(profiled_steps(ren, cam))
            out["runs"].append(run)
            print(f"{mode} pose {i}: wall {run['wall_ms']:.3f} ms/step, "
                  f"events {run['events_ms']:.3f}, thread CPU "
                  f"{run['thread_cpu_ms']:.3f}, process CPU "
                  f"{run['process_cpu_ms']:.3f}, steal "
                  f"{run['steal_share']:.4f}, {run['calls']:.0f} Python "
                  "calls a step", flush=True)
    line = json.dumps(out)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    else:
        print(line)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
