"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Builds the port's CUDA kernels from ``tyrant_tpu_torch/csrc``, holds each
against its plain PyTorch version on the card (on synthetic rays and on
the inputs the main path gives it: the extend queue, the shadow queue, the
AOV pass's primaries and a step's sorted accumulation queue), times each
through its wrapper and the accumulation and stream kernels alone from a
profiler trace (the stream kernel launch by launch), against a bound from
the work these inputs need, runs the bench's equivalence gate (the three
traversal kernels, depth-first mono and wave and breadth-first stream,
against the plain walk) and the stream kernel's overflow check, renders
the main path at full size (1920x1080, 2,097,152-ray queue, 5 bounces,
the seven spheres plus the ~1M-triangle benchmark terrain) from the
benchmark's three poses with a profiled per-stage device-time split, once
with each traversal-kernel generation (``packet_kernel_mode`` "mono" and
"wave"), drives the denoised display path (AOV pass, à-trous denoiser,
bloom) at full size, compares small renders on the card with the same
renders on the CPU, and times the three poses with the pose harness.  The shade kernel is
held against its plain version (``render._shade_plain``) on the queue of
the main cell's next step after three carried steps (the tri_shade
variant, 2,097,152 slots) and on the interactive preset's (the kernel
normals variant, 131,072 slots), and timed against both and a bound; so
is the sphere kernel (``csrc/spheres.cu``, ``spheres_at_slice``) in both
modes, against ``intersect_spheres`` on the extend queue and the
traversal's flags OR ``any_hit_spheres`` on the shadow queue, bit for
bit, with the L2 evicted before each timed call.  Phase 3 counts both of
its modes once a step wherever the scene has spheres.

It then captures the main cell's step as a CUDA graph
(``fuse_step_chains="auto"``): bit for bit the eager step after six
steps with a pose and a sun change between, phase 3 replayed (device
busy and idle share), a graph of one step against a chain of four; the
display path captured (``image()`` bit for bit the eager one); the normals
output of both traversal kernels on the interactive preset's extend queue
(bit for bit the plain version, t and ids unchanged, timed against
``normals=False``); and the interactive fly-through
(``bench/interactive.py``) at the preset's 1920x1080 and 131,072 rays,
40 moving and 40 still frames, with kernel normals and capture each on
and off and the wave kernel: ms a frame, FPS, device busy and idle, the
shade stage from an eager trace, replays counted.

Then two scenes loaded from files it writes into ``build/chip_smoke/scene``
(no download): a JSON description that places the terrain, as a binary PLY
with vertex normals, and instances of an OBJ/MTL asset as a GGX conductor,
as glass of IOR 1.7 and as frosted glass, under the seven spheres, rendered
at full size with ``dispersion=0.02`` under "mono" and "wave"; and a glTF
binary of a double-sided terrain with no sphere, lit by the sun alone.  On
each, the traversal kernels are held against the plain walk on the extend,
shadow and AOV queues and the accumulation against its plain version on a
step's queue.

Last, the lights path on the main scene at full size, in two
configurations written as a JSON description (and a procedural HDR sky
as a PFM) into the same folder: "many" (4,096 of the terrain's triangles
emissive, three emissive spheres, a point, a spot and a directional
light, a 2048x1024 sky; MIS and power light picking by alias rows) and
"few" (32 emissive triangles, the same spheres and delta lights, the sun
and sky; power picking by the CDF, no MIS).  Each runs phase 3 eager and
captured (the captured state bit for bit the eager one) and with the wave
kernel, the traversal kernels on its extend, shadow and AOV queues (the
shadow rays' finite, shrunk ranges toward emissive triangles, which are
BVH geometry) and the accumulation on a step's queue, and a small render
on the card against the CPU.

Then the fog path: the main scene under height fog (``FOG``, the slab
over the terrain's z range), eager and captured at the three poses, with
the wave kernel at pose 0, once with the lights "few" and MIS, and
once in the ``fog_lights_1m`` benchmark configuration's combination (the
4,096 lamps of "many", power picking by alias rows, no MIS, no envmap),
captured at the three poses, each pose's state bit for bit the eager
step's (``fog_lamps_captured``); and
the textures path: ``scene.files.textured_scene`` on the terrain (albedo,
normal and roughness/metal maps, 65,536 alpha-cutout leaves and 1,024
blend triangles, clamp and mirrored wraps, from numpy in memory), eager
and captured at the three poses under "bilinear", eager at pose 0 under
"nearest", "trilinear" and with the wave kernel, the textured shade
kernels (``csrc/shade_textured.cu``) against the plain body on the queue
after 3 more steps under "bilinear" and "nearest" (``shade_at_step``),
and ``image()`` with the denoiser.  Each logs shade's device time with its row gathers counted
from the trace, holds the traversal kernels against the plain walk on its
queues and the accumulation on its step's queue, and compares a 32x32
render on the card with the CPU's.

The front ends and the strip-parallel path: after the pose harness,
``utils.profiling.stage_profile`` on the main cell against phase 3's
stage split, the HTTP viewer on the interactive preset served for 3 s on
127.0.0.1 (frames that advance, ``/frame.png``, an ``/input`` move),
``image(uint8=True)`` with its pinned copy and the PNG encode timed, and
the strips (``parallel/sharded.py``): one strip bit for bit the eager
``Renderer``, two strips on the one card at full width timed with each
strip's launches, and two strips at 32x32 against the CPU; after the
sphere-free scene, the CLI on the loaded path's PLY: ``render`` (its PNG
bit for bit the ``Renderer``'s image after the same steps, its ``--hdr``
EXR the radiance), ``info``, ``bvh-debug`` at 1080p and ``bench``.

The port's benchmark entry (``bench_torch.py``) times the pose harness
(``bench_scene`` on the main cell at 1 s a pose, its Mrays/s within
0.95-1.05x the captured main cell's); after the CLI, the examples
``render_spheres_torch`` and ``render_instances_torch`` run at their
defaults (the latter on a 65,536-triangle terrain PLY), each PNG
decoded.

Run from the root of the repository:

    python3 chip_smoke.py

Exits non-zero, without a result line, when CUDA is unavailable or any
phase fails.  The last line of standard output is
``{"ok": true, "device": {...}}``; the line before it holds the per-kernel
numbers, and the one before that the card's name and power limit.  The
profiler traces of phase 3 are left in ``build/chip_smoke/``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import io
import json
import os
import struct
import subprocess
import sys
import time
import urllib.request
import zlib
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile, record_function

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import bench_torch  # noqa: E402

from tyrant_tpu_torch import adaptive as adaptive_mod  # noqa: E402
from tyrant_tpu_torch import checkpoint  # noqa: E402
from tyrant_tpu_torch import cli  # noqa: E402
from tyrant_tpu_torch import native  # noqa: E402
from tyrant_tpu_torch import render as tr  # noqa: E402
from tyrant_tpu_torch import viewer  # noqa: E402
from tyrant_tpu_torch.bench import equivalence, interactive  # noqa: E402
from tyrant_tpu_torch.bench.poses import camera_for_pose, mrays_per_s  # noqa: E402
from tyrant_tpu_torch.config import (EPSILON, VERY_FAR,  # noqa: E402
                                     RenderConfig, interactive_config,
                                     small_config)
from tyrant_tpu_torch.denoise import atrous_denoise  # noqa: E402
from tyrant_tpu_torch.ops import stream as plain_stream  # noqa: E402
from tyrant_tpu_torch.ops import traverse as plain_trav  # noqa: E402
from tyrant_tpu_torch.ops import kernels  # noqa: E402
from tyrant_tpu_torch.ops.kernels import accum as kacc  # noqa: E402
from tyrant_tpu_torch.ops.kernels import build  # noqa: E402
from tyrant_tpu_torch.ops.intersect import (any_hit_spheres,  # noqa: E402
                                            intersect_spheres)
from tyrant_tpu_torch.ops.kernels import shade as kshade  # noqa: E402
from tyrant_tpu_torch.ops.kernels import spheres as kspheres  # noqa: E402
from tyrant_tpu_torch.ops.kernels import stream as kstream  # noqa: E402
from tyrant_tpu_torch.ops.kernels import traverse as ktrav  # noqa: E402
from tyrant_tpu_torch.ops.tonemap import bloom, resolve  # noqa: E402
from tyrant_tpu_torch.native import ply_native  # noqa: E402
from tyrant_tpu_torch.scene import files as scene_files  # noqa: E402
from tyrant_tpu_torch.scene.description import load_description  # noqa: E402
from tyrant_tpu_torch.scene.instancing import MeshAsset  # noqa: E402
from tyrant_tpu_torch.scene.ply import load_ply_attrs  # noqa: E402
from tyrant_tpu_torch.scene.procgen import benchmark_scene, terrain  # noqa: E402
from tyrant_tpu_torch.scene.scene import Scene  # noqa: E402
from tyrant_tpu_torch.scene.texture import TextureAtlas  # noqa: E402
from tyrant_tpu_torch.parallel import sharded  # noqa: E402
from tyrant_tpu_torch.utils import profiling  # noqa: E402
from tyrant_tpu_torch.utils.exr import read_exr  # noqa: E402

DEV = torch.device("cuda")
STAGES = ("raygen", "extend", "shade", "connect", "sort", "accumulate")
TIE = 1e-3  # hit distances closer than EPSILON: either id is right
ROOT = Path(__file__).resolve().parent
TRACE_DIR = ROOT / "build" / "chip_smoke"
SCENE_DIR = TRACE_DIR / "scene"  # the loaded scenes' files
GENERATIONS = (("mono", False), ("wave", True))

# The card's peaks for the bound (NVIDIA's H100 SXM data sheet, at the
# 700 W limit): HBM3 bytes/s and float32 operations/s outside the tensor
# cores.  Operations a traversal needs, counted from the kernels' source:
# a slab test is 6 subtractions, 6 multiplications, 4 max/min and 3
# compares; a Möller-Trumbore test with its accept rule is 54 operations.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
SLAB_OPS, MT_OPS = 19, 54
# Table bytes a traversal must read: a 64-byte node record a distinct row
# and a 48-byte record a distinct triangle tested
# (ops/kernels/traverse.py:build_kernel_tables), whatever the order of the
# walk.  Breadth-first order adds its frontier: a (ray, row, t) pair of 12
# bytes written and read back once.
NODE_BYTES, TRI_BYTES, PAIR_BYTES = 64, 48, 12
# Accumulation: the 4-byte sort keys through the first at or above P (the
# column is ascending, so the entries after it are a suffix that adds
# nothing), one 32-byte sector for each 256-entry block of that suffix (the
# one read that tells a block of csrc/accum.cu it has no work), the values
# of the entries below P, and the 16-byte row of each distinct pixel read
# and written.
KEY_BYTES, SECTOR_BYTES, ACCUM_BLOCK, PIXEL_ROW_BYTES = 4, 32, 256, 2 * 16
# a buffer written before each timed call to push its inputs out of the
# H100's 50 MB L2, as the step's earlier stages do
L2_EVICT_BYTES = 128 << 20
# the kernels of each wrapper, by the names they carry in a profiler trace
ACCUM_KERNELS = ("accum_kernel",)
SHADE_KERNELS = ("shade_kernel",)
# Shade: the bytes a slot reads (origin, direction, direct: 12 each; pixel,
# bounces, t, ident: 4 each; last_specular, is_tri: 1 each) and writes
# (colour, the next ray's origin, direction and direct, the shadow ray's
# origin, direction and colour: 12 each; bounces, max_dist: 4 each;
# survive, last_specular, valid: 1 each), a 32-byte tri_shade row a slot
# that hits a triangle (tri_shade variant) or 12 bytes of hit normal a
# slot that hits no sphere (kernel normals variant); floats within this of
# the plain version (a row's largest difference over its largest magnitude)
SHADE_READ_BYTES, SHADE_WRITE_BYTES, TRI_SHADE_ROW_BYTES = 54, 95, 32
SHADE_RTOL = 1e-5
# The textured variant's two kernels (csrc/shade_textured.cu).  The
# surface kernel reads the ray fields again (origin, direction: 12 each;
# t, ident, pixel: 4 each; is_tri: 1), a triangle hit's tri_shade row
# and 96 bytes of its tri_attr row, a 32-byte sector a texel tap, and
# writes the 32-byte surface record, which the shade kernel reads back in
# place of is_tri.
SURFACE_KERNELS = ("surface_kernel",)
SHADE_TEXTURED_KERNELS = ("shade_textured_kernel",)
SURFACE_RAY_BYTES, TRI_ATTR_READ_BYTES, TAP_BYTES, RECORD_BYTES = \
    37, 96, 32, 32
# the figures of textured_at_step that the kernels line carries
TEXTURED_AT_STEP = ("rays", "mismatches", "by_category", "ms", "surface_ms",
                    "shade_ms", "surface_kernel_ms", "shade_kernel_ms",
                    "plain_ms", "bound_ms", "surface_bound_ms",
                    "shade_bound_ms", "bound_by", "library_ms")
# what a slot of the textured queue shaded, by the surface record
TEXTURED_CATEGORIES = ("miss", "sphere", "mapped_diff", "ggx", "cutout_pass",
                       "blend_shaded", "blend_passed", "other")
STREAM_KERNELS = ("init_kernel", "level_kernel", "finish_kernel")
# The sphere kernel (csrc/spheres.cu) and its wrapper's launch counters.
# Its bound: the closest hit reads a ray (origin, direction: 24 bytes) and
# writes t and the sphere id (8); the any hit reads the valid and occluded
# flags and writes the result (3), and reads the ray and its max distance
# (28) on a valid slot the traversal left unoccluded; 20 float operations
# a ray-sphere pair (9 for op and its two dots' products, 4 adds, disc's 3
# operations, the square root and the two roots).
SPHERES_KERNELS = ("spheres_kernel",)
SPHERE_KEYS = ("spheres_closest", "spheres_any")
RAY_BYTES, HIT_BYTES, FLAG_BYTES, MAXD_BYTES = 24, 8, 3, 4
SPHERE_PAIR_OPS = 20


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, cold: bool = False) -> float:
    """Mean device time of fn() over reps calls, after one warm-up: back
    to back, or with ``cold`` each call timed alone after a write of
    L2_EVICT_BYTES, so that its inputs come from device memory."""
    fn()
    torch.cuda.synchronize()
    if not cold:
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / reps
    evict = torch.empty(L2_EVICT_BYTES // 4, dtype=torch.float32, device=DEV)
    events = [[torch.cuda.Event(enable_timing=True) for _ in range(2)]
              for _ in range(reps)]
    for a, b in events:
        evict.zero_()
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in events) / reps


def timed_once(fn):
    """(fn(), device ms of that one call): for the plain walks, which run
    once per queue."""
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    out = fn()
    b.record()
    torch.cuda.synchronize()
    return out, a.elapsed_time(b)


def bound_ms(n_bytes: float, n_ops: float) -> tuple[float, str]:
    """The least time the card could take: the larger of bytes over HBM
    rate and operations over the float32 rate, and which one it is."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def accum_bound(n: int, live: int, distinct: int, value_bytes: int,
                buffers: int = 1) -> tuple[float, str]:
    """The accumulation's bound on an ascending key column of ``n``
    entries: the keys through the first at or above P, a sector a block
    of the suffix after it, the values of the ``live`` entries below P,
    the rows of their ``distinct`` pixels read and written in each of the
    ``buffers``; one add a value lane (the count's too), and with the
    moment2 buffer 3 squares and 4 adds more."""
    keys = min(live + 1, n)
    suffix_blocks = -(-(n - keys) // ACCUM_BLOCK)
    return bound_ms(KEY_BYTES * keys + SECTOR_BYTES * suffix_blocks
                    + value_bytes * live
                    + buffers * PIXEL_ROW_BYTES * distinct,
                    (4 + 7 * (buffers - 1)) * live)


def frontier_floor_ms(pairs) -> float:
    """What breadth-first order adds to any traversal's bound: each of the
    ``pairs`` (summed over the levels, the first level's one a ray
    included) written to device memory once and read back once."""
    return 2 * PAIR_BYTES * sum(pairs) / HBM_BYTES_PER_S * 1e3


def kernel_times(fn, names, reps: int = 1) -> list:
    """The kernels that ``reps`` calls of ``fn()`` launch, from a profiler
    trace taken after a warm-up call; ``fn`` launches only kernels named
    with one of ``names``.  For each launch in the calls'
    ``record_function`` range, in launch order: (name, start us, duration
    us) of its kernel, matched by correlation id as in
    :func:`stage_split`, or None where the trace lacks the kernel's record
    (the profiler loses a few records of short kernels: up to 3 of 20 at
    the card tests' sizes, none in the full-size runs so far)."""
    fn()
    torch.cuda.synchronize()
    TRACE_DIR.mkdir(parents=True, exist_ok=True)
    path = TRACE_DIR / "kernels.json"
    # idle margins: the profiler drops device events that fall outside its
    # window on the host's clock
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(0.2)
        with record_function("kernel_times"):
            for _ in range(reps):
                fn()
        torch.cuda.synchronize()
        time.sleep(0.2)
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    (a, b), = [(e["ts"], e["ts"] + e["dur"]) for e in events
               if e.get("cat") == "user_annotation"
               and e["name"] == "kernel_times"]
    api = [e for e in events
           if e.get("cat") in ("cuda_runtime", "cuda_driver")
           and "LaunchKernel" in e["name"] and a <= e["ts"] <= b]
    # a driver launch inside a runtime launch is the same launch
    outer = [(e["ts"], e["ts"] + e["dur"]) for e in api
             if e["cat"] == "cuda_runtime"]
    launches = sorted((e["ts"], e["args"]["correlation"]) for e in api
                      if e["cat"] == "cuda_runtime"
                      or not any(x <= e["ts"] <= y for x, y in outer))
    kernels = {e["args"]["correlation"]:
               (next(n for n in names if n in e["name"]), e["ts"], e["dur"])
               for e in events if e.get("cat") == "kernel"
               and any(n in e["name"] for n in names)}
    return [kernels.get(c) for _, c in launches]


def kernel_ms(fn, names, reps: int = 20) -> float | None:
    """Mean device ms of the one named kernel that each ``fn()`` call
    launches, over the kernels a profiler trace of ``reps`` calls holds:
    the kernel alone, without the wrapper.  None, said in the log, when
    the trace does not show one launch a call or lost every record: a
    timing that could not be read, not a fault of the kernel."""
    traced = kernel_times(fn, names, reps)
    found = [k for k in traced if k is not None]
    if len(traced) != reps or not found:
        log(f"kernel alone not measured: {len(traced)} launches and "
            f"{len(found)} kernels named {names} traced in {reps} calls")
        return None
    return sum(dur for *_, dur in found) / len(found) / 1e3


def fmt_ms(ms: float | None) -> str:
    return "not measured" if ms is None else f"{ms:.4f} ms"


def phase0() -> float:
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    nvcc = subprocess.run([build._nvcc(), "--version"], capture_output=True,
                          text=True, timeout=60).stdout.strip().splitlines()
    log(f"nvcc: {nvcc[-1] if nvcc else 'unknown'}")
    t0 = time.perf_counter()
    build.load()
    t = time.perf_counter() - t0
    log(f"kernel build+load {t:.2f} s (nvcc {build.build_seconds} s) -> "
        f"{build.library_path().relative_to(build.BUILD_DIR.parents[1])}")
    log("registers a thread and spill bytes (ptxas --resource-usage): "
        f"{build.registers()}")
    # the native host library (BVH builder, PLY loader): built here, so a
    # failing g++ stops the run instead of leaving the Python builder and
    # loader to stand in
    t0 = time.perf_counter()
    native.get_lib()
    log(f"native host library build+load {time.perf_counter() - t0:.2f} s -> "
        f"{native.library_path().relative_to(native.BUILD_DIR.parents[1])}")
    return t


def check_closest(what: str, t_k, id_k, t_p, id_p) -> dict:
    """Kernel against plain closest hits: ids equal except epsilon ties
    (|dt| > TIE is a mismatch), t at rtol 1e-4 where the ids agree."""
    t_k, id_k, t_p, id_p = (x.cpu().numpy() for x in (t_k, id_k, t_p, id_p))
    differ = id_k != id_p
    with np.errstate(invalid="ignore"):
        bad = differ & ~(np.abs(t_k - t_p) <= TIE)
    same_hit = ~differ & (id_p >= 0)
    err = float(np.abs(t_k[same_hit] - t_p[same_hit]).max()) \
        if same_hit.any() else 0.0
    log(f"{what}: {float(np.mean(id_p >= 0)):.3f} hit a triangle, "
        f"{int(differ.sum())} "
        f"id ties, {int(bad.sum())} mismatches, max |dt| {err:.3g}")
    if bad.any():
        raise AssertionError(f"{what}: ids differ on {int(bad.sum())} rays")
    if not np.allclose(t_k[~differ], t_p[~differ], rtol=1e-4, atol=0):
        raise AssertionError(f"{what}: t differs beyond rtol 1e-4")
    return dict(rays=int(id_p.size), hits=int((id_p >= 0).sum()),
                ties=int(differ.sum()), mismatches=0, max_dt=err)


def check_any(what: str, occ_k, occ_p) -> dict:
    """Kernel against plain any-hit flags: exactly equal."""
    n_bad = int((occ_k != occ_p).sum())
    n_occ = int(occ_p.sum())
    log(f"{what}: {n_occ} of {occ_p.shape[0]} occluded, {n_bad} mismatches")
    if n_bad:
        raise AssertionError(f"{what}: flags differ on {n_bad} rays")
    return dict(rays=int(occ_p.shape[0]), occluded=n_occ, mismatches=0)


def check_stream(what: str, o, d, t, tables, t_walk, id_walk,
                 cap_mult: int = 3, reps: int = 5) -> dict:
    """The stream kernel against its plain version on the card (ids equal,
    t equal bit for bit, the same pairs at every level) and against the
    depth-first walk's (t_walk, id_walk) with the tie rule; timed through
    the wrapper beside the plain version, and kernel by kernel from a
    profiler trace of one call (each launch's device time, the pairs of
    its level and the gap since the launch before).  ``cap_mult`` grows
    until the frontier fits.  The frontier floor counts the pairs the
    plain version made."""
    if t is None:  # the wrapper's default, made here so that a traced
        # call launches the kernel's own launches alone
        t = torch.full((o.shape[0],), VERY_FAR, dtype=torch.float32,
                       device=o.device)
    while True:
        stats_k = {}
        t_k, id_k, ovf = kstream.closest_hit_stream(
            o, d, tables, t, cap_mult=cap_mult, return_overflow=True,
            stats=stats_k)
        if not int(ovf):
            break
        log(f"{what} stream: the frontier overflows at cap_mult={cap_mult} "
            f"(a level asked for {max(stats_k['pairs'])} pairs, capacity "
            f"{plain_stream.capacity(o.shape[0], cap_mult)}); trying "
            f"{cap_mult + 1}")
        cap_mult += 1
    stats_p = {}
    rows = tables.rows.to(o.device)  # the plain version's fat rows
    (t_p, id_p, ovf_p), plain_ms = timed_once(
        lambda: plain_stream.closest_hit_stream(
            o, d, rows, tables.max_depth, t, cap_mult, stats=stats_p))
    del rows
    n_id = int((id_k != id_p).sum())
    n_t = int((t_k.view(torch.int32) != t_p.view(torch.int32)).sum())
    if n_id or n_t or int(ovf_p) or stats_k["pairs"] != stats_p["pairs"]:
        raise AssertionError(
            f"{what} stream against its plain version: {n_id} ids and {n_t} "
            f"t differ, plain overflow {int(ovf_p)}, pairs a level "
            f"{stats_k['pairs']} against {stats_p['pairs']}")
    vs_walk = check_closest(f"{what} stream vs walk", t_k, id_k, t_walk,
                            id_walk)

    def call():
        return kstream.closest_hit_stream(o, d, tables, t, cap_mult=cap_mult,
                                          return_overflow=True)

    before = kstream.launches
    call()
    per_call = kstream.launches - before
    ms = cuda_ms(call, reps)
    launched = kernel_times(call, STREAM_KERNELS)
    if len(launched) != per_call + 2:  # the levels, init and finish
        log(f"{what} stream: {len(launched)} launches traced for "
            f"{per_call} levels; no launch's time is known")
        launched = [None] * (per_call + 2)
    # launch order: init, the levels, finish; a kernel whose record the
    # profiler lost leaves its launch's time (and the call's sum) unknown
    split, prev_end = [], None
    for k, rec in enumerate(launched):
        kernel = "init_kernel" if k == 0 else "finish_kernel" \
            if k == per_call + 1 else "level_kernel"
        pairs = None if kernel != "level_kernel" else (
            stats_p["pairs"][k - 1] if k - 1 < len(stats_p["pairs"]) else 0)
        start, dur = rec[1:] if rec else (None, None)
        split.append(dict(kernel=kernel, pairs=pairs, us=dur,
                          gap_us=None if None in (prev_end, start)
                          else start - prev_end))
        prev_end = None if rec is None else start + dur
    lost = launched.count(None)
    kernel_alone = span = None
    if not lost:
        kernel_alone = sum(dur for *_, dur in launched) / 1e3
        span = (launched[-1][1] + launched[-1][2] - launched[0][1]) / 1e3
    n = o.shape[0]
    peak = max(stats_p["pairs"])
    total_pairs = sum(stats_p["pairs"])
    floor = frontier_floor_ms(stats_p["pairs"])
    alone = (f"kernels alone {kernel_alone:.4f} ms over a span of "
             f"{span:.4f} ms" if not lost else
             f"{lost} of {len(launched)} kernel records lost by the profiler")
    log(f"{what} stream: wrapper {ms:.4f} ms, {alone}, plain "
        f"{plain_ms:.3f} ms; 0 id "
        f"and 0 t differences against the plain version; {stats_p['levels']} "
        f"levels, {total_pairs} pairs, peak frontier {peak} pairs "
        f"({peak / n:.3f}x the {n} rays) at cap_mult={cap_mult}; "
        f"{per_call} launches a call; frontier floor {floor:.4f} ms; "
        f"{stats_p['box_tests']} boxes, {stats_p['tri_tests']} triangles")
    log(f"{what} stream, device us a launch (pairs, gap since the launch "
        "before): " + "; ".join(
            f"{x['kernel']} " + ("" if x["pairs"] is None
                                 else f"({x['pairs']}) ")
            + ("lost" if x["us"] is None else f"{x['us']:.3f}")
            + ("" if x["gap_us"] is None else f" (gap {x['gap_us']:.3f})")
            for x in split))
    return dict(vs_walk, ms=ms, kernel_ms=kernel_alone, span_ms=span,
                plain_ms=plain_ms, max_abs_err=0.0, cap_mult=cap_mult,
                levels=stats_p["levels"], pairs=stats_p["pairs"],
                total_pairs=total_pairs, frontier_floor_ms=floor,
                peak_over_rays=peak / n, launches_per_call=per_call,
                launch_split=split, box_tests=stats_p["box_tests"],
                tri_tests=stats_p["tri_tests"])


def bench_rays(bvh, n_rays: int, seed: int = 2024):
    """bench.py's recipe (half box-random, half aimed into the mesh) plus a
    few hundred axis-aligned rays starting on the root box's planes."""
    r = np.random.default_rng(seed)
    node = bvh.node_packed.cpu().numpy()
    lo, hi = node[0, 0:3], node[0, 3:6]
    o = (lo + (hi - lo) * r.uniform(-0.2, 1.2, (n_rays, 3))).astype(np.float32)
    d = r.normal(size=(n_rays, 3)).astype(np.float32)
    half = n_rays // 2
    tgt = lo + (hi - lo) * r.uniform(0.2, 0.8, (half, 3))
    d[half:] = (tgt - o[half:]).astype(np.float32)
    k = min(512, n_rays // 8)
    o[:k] = lo + (hi - lo) * r.uniform(0, 1, (k, 3))
    axis = r.integers(0, 3, k)
    o[np.arange(k), axis] = np.where(r.random(k) < 0.5, lo[axis], hi[axis])
    d[:k] = 0.0
    d[np.arange(k), (axis + 1) % 3] = np.where(r.random(k) < 0.5, 1.0, -1.0)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return (torch.from_numpy(o).to(DEV), torch.from_numpy(d.astype(np.float32))
            .to(DEV), float((hi - lo).max()))


def phase1(scene, tables, n_rays: int = 65_536) -> dict:
    """The traversal kernels against the plain walk on bench.py's rays,
    with origins on box planes (NaN slab distances): mono and wave closest
    and any hit, stream closest (``cap_mult=8``, as the gate) and its
    overflow at ``cap_mult=1``.  Returns {generation: {"closest": ...,
    "any": ...}} and {"stream": {"closest": ..., "overflow": ...}}."""
    o, d, span = bench_rays(scene.bvh, n_rays)
    t_p, id_p = plain_trav.closest_hit(o, d, scene.bvh)
    # hits: half with the max distance past the hit (occluded), half short
    # of it (clear); misses: the scene's span
    t_np, hits = t_p.cpu().numpy(), id_p.cpu().numpy() >= 0
    past = np.arange(n_rays) % 2 == 0
    maxd = torch.from_numpy(np.where(hits, np.where(past, t_np * 1.01 + 0.01,
                                                    t_np * 0.99), span)
                            .astype(np.float32)).to(DEV)
    active = torch.arange(n_rays, device=DEV) % 5 != 0
    occ_p = plain_trav.any_hit(o, d, maxd, scene.bvh, active=active)
    out, ids = {}, {}
    for gen, wave in GENERATIONS:
        t_k, ids[gen] = ktrav.closest_hit_packets(o, d, tables, wave=wave)
        closest = check_closest(f"phase 1 {gen} closest", t_k, ids[gen],
                                t_p, id_p)
        if not closest["hits"]:
            raise AssertionError("phase 1: no ray hit the mesh")
        occ_k = ktrav.any_hit_packets(o, d, maxd, tables, active=active,
                                      wave=wave)
        anyhit = check_any(f"phase 1 {gen} any hit", occ_k, occ_p)
        if not anyhit["occluded"]:
            raise AssertionError("phase 1: no shadow ray was occluded")
        out[gen] = dict(closest=closest, any=anyhit)
    vs_mono = int((ids["wave"] != ids["mono"]).sum())
    out["wave"]["closest"]["ties_vs_mono"] = vs_mono
    log(f"phase 1 wave closest: {vs_mono} id ties against the mono kernel")
    out["stream"] = dict(closest=check_stream("phase 1", o, d, None, tables,
                                              t_p, id_p, cap_mult=8))
    out["stream"]["overflow"] = overflow(o, d, tables)
    return out


def overflow(o, d, tables) -> dict:
    """cap_mult=1 must raise, and set the flag with return_overflow."""
    try:
        kstream.closest_hit_stream(o, d, tables, cap_mult=1)
    except RuntimeError as e:
        if "frontier overflow" not in str(e):
            raise
    else:
        raise AssertionError("cap_mult=1 did not raise the overflow")
    stats = {}
    *_, ovf = kstream.closest_hit_stream(o, d, tables, cap_mult=1,
                                         return_overflow=True, stats=stats)
    if int(ovf) != 1:
        raise AssertionError(f"overflow flag {int(ovf)} at cap_mult=1")
    n, cap = o.shape[0], plain_stream.capacity(o.shape[0], 1)
    peak = max(stats["pairs"])
    log(f"overflow: cap_mult=1 raised, flag 1; a level asked for {peak} "
        f"pairs ({peak / n:.3f}x the {n} rays) past the capacity {cap}")
    return dict(raised=True, flag=1, capacity=cap, peak_asked=peak)


def gate(sd) -> dict:
    """The equivalence gate (mono, wave and stream against the plain walk)
    on the scene: a path of its own, counted from 0."""
    reset_launches()
    t0 = time.perf_counter()
    res = equivalence.check_equivalence(sd, device=DEV)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_launches()
    log(f"equivalence gate: {res!r} in {seconds:.2f} s, launches {launches}")
    if res != "ok":
        raise AssertionError(f"equivalence gate: {res}")
    if not (launches["traverse"] and launches["traverse_wave"]
            and launches["stream"]):
        raise AssertionError(f"the gate missed a kernel: {launches}")
    return dict(result=res, seconds=seconds, launches=launches)


def bench_path(sd, cfg: RenderConfig, main_mrays: float) -> dict:
    """The pose harness through the port's benchmark entry
    (``bench_torch.bench_scene``: bench.py's configuration, 4 warm-up
    steps) on the main cell's scene at 1 s a pose, counted from 0: all
    three poses, finite positive times, and a mean within 0.95-1.05x
    ``main_mrays``, the captured main cell's mean over the same poses."""
    reset_launches()
    d, bcfg = bench_torch.bench_scene(sd, 1.0)
    torch.cuda.synchronize()
    launches = read_launches()
    ratio = d["total_mrays_per_s"] / main_mrays
    for r in d["poses"]:
        log(f"harness pose {r['pose']}: {r['avg_ms']:.3f} ms/step over "
            f"{r['frames']} steps ({r['min_ms']:.3f}-{r['max_ms']:.3f}, "
            f"spread {r['spread_pct']}%, {r['retries']} retries), "
            f"{r['total_mrays_per_s']:.3f} Mrays/s")
    log(f"harness launches: {launches}")
    log(f"harness: mean {d['total_mrays_per_s']:.3f} Mrays/s, {ratio:.3f}x "
        f"the captured main cell's {main_mrays:.3f}; " + json.dumps(d))
    if dataclasses.replace(bcfg, use_packet_kernel=cfg.use_packet_kernel) \
            != cfg:
        raise AssertionError(f"bench_torch's configuration is not the main "
                             f"cell's: {bcfg}")
    if len(d["poses"]) != 3 or not all(
            np.isfinite(r[k]) and r[k] > 0 for r in d["poses"]
            for k in ("avg_ms", "min_ms", "max_ms", "total_mrays_per_s")):
        raise AssertionError(f"harness results: {d}")
    if not 0.95 <= ratio <= 1.05:
        raise AssertionError(f"bench_torch.bench_scene: {ratio:.3f}x the "
                             "captured main cell")
    if not (launches["traverse"] and launches["accumulate"]) \
            or launches["stream"]:
        raise AssertionError(f"the harness did not run through the kernels: "
                             f"{launches}")
    return dict(d, launches=launches, main_mrays_per_s=main_mrays,
                ratio=ratio)


def live_entries(key, p: int) -> tuple[int, int]:
    """(entries below p, distinct pixels among them) of a sorted key."""
    live = key[key < p]
    return int(live.numel()), int(torch.unique_consecutive(live).numel())


def same_bits(a, b) -> bool:
    return torch.equal(a.contiguous().view(torch.int32),
                       b.contiguous().view(torch.int32))


def index_add_ms(accum, pix, vals, live: int, reps: int,
                 cold: bool = False) -> float:
    """The library call for the accumulation: one index_add_ of the
    ``live`` entries below P (the sorted column's prefix) into a copy of
    ``accum``."""
    acc = accum.clone()
    pix_l, vals_l = pix[:live], vals[:live]
    return cuda_ms(lambda: acc.index_add_(0, pix_l, vals_l), reps, cold)


def phase2(p: int, n: int) -> dict:
    """Accumulation kernel against the plain version on CPU copies (bit
    for bit), timed through the wrapper and kernel alone beside the plain
    version and one index_add_ call."""
    r = np.random.default_rng(7)
    accum = r.random((p, 4)).astype(np.float32)
    pix = r.integers(0, p, n)
    pix = np.sort(np.where(r.random(n) < 0.1, kacc.sentinel(p), pix)) \
        .astype(np.int32)
    vals = r.random((n, 4)).astype(np.float32)
    vals[:, 3] = 1.0
    want = kacc.accumulate_plain(torch.from_numpy(accum.copy()),
                                 torch.from_numpy(pix), torch.from_numpy(vals))
    acc_d = torch.from_numpy(accum).to(DEV)
    pix_d, vals_d = torch.from_numpy(pix).to(DEV), torch.from_numpy(vals).to(DEV)
    got = kacc.accumulate_sorted(acc_d, pix_d, vals_d).cpu()
    err = float((got - want).abs().max())
    log(f"phase 2 accumulate: P={p} N={n} max |err| {err:.3g}")
    if not same_bits(got, want):
        raise AssertionError("phase 2: the kernel differs from the plain "
                             "version's sequential scatter")

    def call():
        return kacc.accumulate_sorted(acc_d, pix_d, vals_d)

    ms = cuda_ms(call, 20)
    k_ms = kernel_ms(call, ACCUM_KERNELS)
    plain_ms = cuda_ms(lambda: kacc.accumulate_plain(acc_d, pix_d, vals_d), 20)
    live, distinct = live_entries(pix_d, p)
    library_ms = index_add_ms(acc_d, pix_d, vals_d, live, 20)
    bnd, by = accum_bound(n, live, distinct, 16)
    log(f"phase 2 timing: wrapper {ms:.4f} ms, kernel alone {fmt_ms(k_ms)}, "
        f"plain {plain_ms:.4f} ms, index_add_ {library_ms:.4f} ms, bound "
        f"{bnd:.4f} ms ({by}: {live} entries below P on {distinct} pixels)")
    return dict(max_abs_err=err, ms=ms, kernel_ms=k_ms, plain_ms=plain_ms,
                library_ms=library_ms, bound_ms=bnd, bound_by=by,
                live=live, distinct=distinct)


def step_queue(ren):
    """(key_s, pend_s): the sorted key [N] i32 and pending radiance [N, 3]
    that the accumulate stage of the step just run was given, rebuilt from
    the state that step returned (its rays and pending radiance are in
    sorted order, the survivors last)."""
    st, cfg = ren.state, ren.cfg
    n = cfg.num_rays
    survive = torch.arange(n, device=st.accum.device) >= n - st.n_carried
    key = tr.compaction_sort_key(
        {"origin": st.origin, "direction": st.direction, "pixel": st.pixel},
        survive, ren.scene.bvh.node_packed, kacc.sentinel(cfg.num_pixels))
    if not bool((key[1:] >= key[:-1]).all()):
        raise AssertionError("the rebuilt sort key is not ascending")
    return key.contiguous(), st.pending


def accum_at_step(ren, reps: int = 20) -> dict:
    """The accumulation on the queue of the step just run: through
    ``accumulate_terminated`` (the stage's call) and ``accumulate_sorted``
    on the updates the plain version builds from it, each bit for bit
    against the plain version on the CPU.  ``accumulate_terminated``, the
    plain version and index_add_ are timed with the L2 evicted before
    each call, as in the step, where the 33 MB buffer comes from device
    memory; the kernel alone back to back, with the buffer in the L2, is
    a side note (the kernel alone in the step is phase 3's)."""
    key, pend = step_queue(ren)
    p = ren.cfg.num_pixels
    n = key.shape[0]
    acc0 = ren.state.accum.clone()
    upd_pix, upd_vals = kacc.terminated_updates(key, pend, p)
    want = kacc.accumulate_plain(acc0.cpu().clone(), upd_pix.cpu(),
                                 upd_vals.cpu())
    got_t = kacc.accumulate_terminated(acc0.clone(), key, pend).cpu()
    got_s = kacc.accumulate_sorted(acc0.clone(), upd_pix, upd_vals).cpu()
    if not (same_bits(got_t, want) and same_bits(got_s, want)):
        raise AssertionError("accumulation on the step's queue differs from "
                             "the plain version")
    acc = acc0.clone()

    def terminated():
        return kacc.accumulate_terminated(acc, key, pend)

    live, distinct = live_entries(key, p)
    out = dict(rays=n, max_abs_err=0.0, live=live, distinct=distinct,
               ms=cuda_ms(terminated, reps, cold=True),
               kernel_ms_warm_l2=kernel_ms(terminated, ACCUM_KERNELS),
               plain_ms=cuda_ms(lambda: kacc.accumulate_plain(
                   acc, *kacc.terminated_updates(key, pend, p)), reps,
                   cold=True),
               library_ms=index_add_ms(acc0, upd_pix, upd_vals, live, reps,
                                       cold=True))
    out["bound_ms"], out["bound_by"] = accum_bound(n, live, distinct, 12)
    log(f"step accumulate: {live} of {n} entries below P on {distinct} "
        f"pixels; bit for bit the plain version through both wrappers; "
        f"with the L2 evicted: accumulate_terminated {out['ms']:.4f} ms, "
        f"plain {out['plain_ms']:.4f} ms, index_add_ "
        f"{out['library_ms']:.4f} ms; bound {out['bound_ms']:.4f} ms "
        f"({out['bound_by']}); back to back, the buffer in the L2: kernel "
        f"alone {fmt_ms(out['kernel_ms_warm_l2'])}")
    return out


# the outputs that a miss of the textured variant leaves unequal: the
# plain body computes them from triangle 0's maps, and no stage reads them
MISS_UNREAD = ("next.origin", "shadow.origin", "shadow.direction",
               "shadow.max_dist")


def shade_bad_slots(fused, plain, hit_mask=None) -> dict:
    """The slots where the shade kernel's outputs (color, survive,
    next_rays, shadow) differ from the plain version's, a bool mask a
    field: survive, shadow.valid, the sun-or-light pick (max_dist at
    VERY_FAR), pixel, bounces and last_specular exactly, the floats beyond
    SHADE_RTOL (a row's largest difference over its largest magnitude),
    the shadow colour where the ray is valid, the fields of MISS_UNREAD
    where ``hit_mask`` holds (every slot when None)."""
    fc, fs, fn, fsh = fused
    pc, ps, pn, psh = plain
    far = float(np.float32(VERY_FAR))
    valid = psh["valid"]
    exact = {"survive": (fs, ps), "shadow.valid": (fsh["valid"], valid),
             "sun_pick": (fsh["max_dist"] == far, psh["max_dist"] == far),
             **{f"next.{k}": (fn[k], pn[k])
                for k in ("pixel", "bounces", "last_specular")}}
    floats = {"color": (fc, pc),
              **{f"next.{k}": (fn[k], pn[k])
                 for k in ("origin", "direction", "direct")},
              **{f"shadow.{k}": (fsh[k], psh[k])
                 for k in ("origin", "direction", "max_dist", "color")}}
    out = {name: a != b for name, (a, b) in exact.items()}
    for name, (a, b) in floats.items():
        a2, b2 = (a, b) if a.ndim == 2 else (a[:, None], b[:, None])
        out[name] = (a2 - b2).abs().amax(-1) > SHADE_RTOL * b2.abs().amax(-1)
    out["shadow.color"] &= valid
    if hit_mask is not None:
        for k in MISS_UNREAD:
            out[k] &= hit_mask
    return out


def shade_mismatches(fused, plain, hit_mask=None) -> tuple[dict, int, int]:
    """The counts of :func:`shade_bad_slots` a field, and an invalid
    shadow ray's colour, which must be 0 in the kernel.  Also the float
    elements compared that are equal bit for bit, and of how many."""
    fc, fs, fn, fsh = fused
    pc, ps, pn, psh = plain
    valid = psh["valid"]
    out = {k: int(v.sum()) for k, v in shade_bad_slots(
        fused, plain, hit_mask).items()}
    n_eq = n_el = 0
    for a, b, mask in [(fc, pc, None)] \
            + [(fn[k], pn[k], hit_mask if k == "origin" else None)
               for k in ("origin", "direction", "direct")] \
            + [(fsh[k], psh[k], valid if k == "color" else hit_mask)
               for k in ("origin", "direction", "max_dist", "color")]:
        eq = a == b
        eq = eq if mask is None else eq[mask]
        n_eq, n_el = n_eq + int(eq.sum()), n_el + eq.numel()
    out["shadow.color.invalid_nonzero"] = int(
        (fsh["color"][~valid] != 0).any(-1).sum())
    return out, n_eq, n_el


def textured_categories(sc, t, ident, is_tri, record) -> torch.Tensor:
    """What each slot of a textured queue shaded, as an index into
    TEXTURED_CATEGORIES, from the surface record's material word and the
    hit triangle's blend flag (its tri_shade refl lane)."""
    word = record.view(torch.int32)[:, 7]
    refl = word & 0xFF
    hit = t < VERY_FAR
    tid = ident.clamp(0, sc.tri_shade.shape[0] - 1).long()
    lane = sc.tri_shade[tid, 3].to(torch.int32)
    lane = torch.where(lane >= 32, lane - 32, lane)
    blend = is_tri & (lane >= 16) if sc.has_blend else torch.zeros_like(hit)
    mapped = (word & kshade.TEX_HIT_BIT) != 0
    tri = hit & is_tri
    cat = torch.full_like(refl, TEXTURED_CATEGORIES.index("other"))
    rules = [("mapped_diff", tri & ~blend & mapped & (refl == 0)),
             ("ggx", tri & (refl == tr.GGX)),
             ("cutout_pass", tri & ~blend & (refl == tr.PASS)),
             ("blend_shaded", tri & blend & (refl != tr.PASS)),
             ("blend_passed", tri & blend & (refl == tr.PASS)),
             ("sphere", hit & ~is_tri), ("miss", ~hit)]
    for name, m in rules:
        cat = torch.where(m, TEXTURED_CATEGORIES.index(name), cat)
    return cat


def by_category(cat, bad) -> dict:
    """{category: (slots, slots off)} of a textured queue."""
    return {c: (int((cat == k).sum()), int(((cat == k) & bad).sum()))
            for k, c in enumerate(TEXTURED_CATEGORIES)}


def shade_at_step(ren, steps: int = 3, reps: int = 20) -> dict:
    """The shade kernels on the queue of ``ren``'s next step at pose 0,
    after ``steps`` more steps (so the queue holds carried rays): the
    variant ``ren``'s configuration takes (the textured one on a scene
    with a flag of ``kshade.GATE_BITS``; else the base kernel with the
    traversal's hit normals where ``render.kernel_normals`` holds, or with
    the tri_shade rows, as ``kshade.variant`` picks), through
    ``ops/kernels/shade``, against ``render._shade_plain`` on the same
    tensors, with no mismatch of :func:`shade_mismatches` (the textured
    variant's MISS_UNREAD compared on the hits: a miss's are never read).
    The wrapper and the plain version timed with CUDA events, the L2
    evicted before each call (the extend stage leaves the queue in device
    memory); the kernel alone from a profiler trace, back to back.  The
    bound: the bytes the slots touch, each once (SHADE_READ_BYTES and
    SHADE_WRITE_BYTES a slot, and the triangle rows or hit normals the
    slots read; the textured variant's are :func:`textured_bound`'s).  No
    library offers the stage, so ``library_ms`` is None."""
    cfg, sc = ren.cfg, ren.scene
    cam = camera_for_pose(0)
    ren.step(cam, steps)
    st = ren.state
    rays = tr.merge_queue(cfg, st, cam.to_device(cfg, DEV))
    normals = tr.kernel_normals(cfg, sc)
    t, ident, is_tri, *tn = tr._intersect_scene(
        rays["origin"], rays["direction"], sc, ren.tables, normals=normals)
    args = (cfg, sc, ren.sky_params, ren.sun_dir, rays, t, ident, is_tri,
            tr._salted_frame(cfg, st.frame), tn[0] if normals else None)
    kind = kshade.variant(cfg, sc, DEV)
    if kind is None:
        raise AssertionError("the shade kernel does not take this queue")
    if kind == kshade.TEXTURED:
        return textured_at_step(ren, args, reps)
    got, n_eq, n_el = shade_mismatches(kshade.shade(*args),
                                       tr._shade_plain(*args))
    n = cfg.num_rays
    hit = t < VERY_FAR
    tri_hits = int((hit & is_tri).sum())
    sphere_hits = int((hit & ~is_tri).sum())
    variant = "kernel_normals" if normals else "tri_shade"
    out = dict(variant=variant, rays=n, carried=int(st.n_carried),
               tri_hits=tri_hits, sphere_hits=sphere_hits, mismatches=got,
               float_elements_equal=n_eq, float_elements=n_el,
               ms=cuda_ms(lambda: kshade.shade(*args), reps, cold=True),
               kernel_ms=kernel_ms(lambda: kshade.shade(*args),
                                   SHADE_KERNELS),
               plain_ms=cuda_ms(lambda: tr._shade_plain(*args), 5,
                                cold=True),
               library_ms=None)
    extra = (n - sphere_hits) * 12 if normals \
        else tri_hits * TRI_SHADE_ROW_BYTES
    out["bound_ms"], out["bound_by"] = bound_ms(
        n * (SHADE_READ_BYTES + SHADE_WRITE_BYTES) + extra, 0)
    log(f"shade {variant} at a step ({n} slots, {out['carried']} carried, "
        f"{tri_hits} triangle and {sphere_hits} sphere hits): mismatches "
        f"{json.dumps(got)}; float elements bit for bit {n_eq}/{n_el}; with "
        f"the L2 evicted: kernel {out['ms']:.4f} ms, plain "
        f"{out['plain_ms']:.4f} ms; kernel alone back to back "
        f"{fmt_ms(out['kernel_ms'])}; bound {out['bound_ms']:.4f} ms "
        f"({out['bound_by']})")
    if any(got.values()):
        raise AssertionError(f"the shade kernel differs from the plain "
                             f"version on the {variant} queue: {got}")
    return out


def spheres_at_slice(ren, steps: int = 3, reps: int = 20) -> dict:
    """Both modes of the sphere kernel (``csrc/spheres.cu``,
    ``ops/kernels/spheres.py``) on the queues of ``ren``'s next step at pose
    0, after ``steps`` more steps (so the queue holds carried rays): the
    closest hit on the extend queue, the any hit on the shadow queue that
    shade makes from those hits, with the traversal's occluded flags.  Each
    against its plain version on the same tensors (``intersect_spheres``;
    the traversal's flags OR ``any_hit_spheres``), bit for bit: t, the
    sphere id, the flags.  The wrapper and the plain chain timed with CUDA
    events, the L2 evicted before each call (the stage before leaves the
    queue in device memory); the kernel alone from a profiler trace, back
    to back; the bound in bytes (RAY_BYTES, HIT_BYTES, FLAG_BYTES and
    MAXD_BYTES a slot).  No library offers the test, so ``library_ms`` is
    None."""
    cfg, sc = ren.cfg, ren.scene
    cam = camera_for_pose(0)
    ren.step(cam, steps)
    st = ren.state
    rays = tr.merge_queue(cfg, st, cam.to_device(cfg, DEV))
    o, d = rays["origin"], rays["direction"]
    c, r = sc.sphere_center, sc.sphere_radius
    n, s = o.shape[0], c.shape[0]
    normals = tr.kernel_normals(cfg, sc)
    t, ident, is_tri, *tn = tr._intersect_scene(o, d, sc, ren.tables,
                                                normals=normals)
    _, _, _, shadow = tr._shade(cfg, sc, ren.sky_params, ren.sun_dir, rays,
                                t, ident, is_tri,
                                tr._salted_frame(cfg, st.frame),
                                tri_normal=tn[0] if normals else None)
    so, sd = shadow["origin"], shadow["direction"]
    valid, md = shadow["valid"], shadow["max_dist"]
    maxd = torch.where(valid, md, torch.zeros_like(md))
    occ = ktrav.any_hit_packets(so, sd, maxd, ren.tables)
    modes = {
        "closest": (lambda: kspheres.closest(o, d, c, r),
                    lambda: intersect_spheres(o, d, c, r)),
        "any": (lambda: kspheres.any_hit(so, sd, c, r, occ, md, valid),
                lambda: occ | any_hit_spheres(so, sd, c, r, maxd))}
    (t_k, id_k), (t_p, id_p) = (f() for f in modes["closest"])
    any_k, any_p = (f() for f in modes["any"])
    tested = int((valid & ~occ & (md > 0)).sum())
    out = dict(rays=n, spheres=s, carried=int(st.n_carried))
    out["closest"] = dict(
        t_mismatches=int((t_k.view(torch.int32)
                          != t_p.view(torch.int32)).sum()),
        id_mismatches=int((id_k != id_p).sum()),
        sphere_hits=int((id_p >= 0).sum()))
    out["any"] = dict(mismatches=int((any_k != any_p).sum()),
                      valid=int(valid.sum()), tested=tested,
                      traversal_occluded=int(occ.sum()),
                      sphere_occluded=int((any_p & ~occ).sum()))
    bounds = {"closest": (n * (RAY_BYTES + HIT_BYTES),
                          n * s * SPHERE_PAIR_OPS),
              "any": (n * FLAG_BYTES + tested * (RAY_BYTES + MAXD_BYTES),
                      tested * s * SPHERE_PAIR_OPS)}
    for mode, (kernel, plain) in modes.items():
        e = out[mode]
        e["ms"] = cuda_ms(kernel, reps, cold=True)
        e["kernel_ms"] = kernel_ms(kernel, SPHERES_KERNELS)
        e["plain_ms"] = cuda_ms(plain, 5, cold=True)
        e["bound_ms"], e["bound_by"] = bound_ms(*bounds[mode])
        e["library_ms"] = None
    log(f"spheres at a step ({n} slots, {out['carried']} carried, {s} "
        f"spheres): closest {json.dumps(out['closest'])}; any hit "
        f"{json.dumps(out['any'])}")
    bad = out["closest"]["t_mismatches"] + out["closest"]["id_mismatches"] \
        + out["any"]["mismatches"]
    if bad:
        raise AssertionError(f"the sphere kernel differs from the plain "
                             f"version: {out}")
    return out


def textured_bound(args) -> dict:
    """The textured variant's bound a kernel, in bytes at HBM rate, on
    the queue of ``args`` (``render._shade``'s): the surface kernel's ray
    fields and record a slot, the tri_shade row and 96 bytes of the
    tri_attr row of each distinct hit triangle, and each distinct 32-byte
    atlas sector that the taps of the hit triangles' maps touch (the
    plain body's taps, 4 a map under "bilinear", 1 under "nearest", for
    each of the albedo, normal and rough maps a triangle has); the shade
    kernel's ray fields (the base kernel's reads less is_tri), the
    record read back, the base kernel's writes.  Every byte is counted
    once, so neighbouring rays that share a sector or a triangle in the
    L2 do not lower the bound below the time it shows."""
    cfg, sc, t, ident, is_tri = args[0], args[1], args[5], args[6], args[7]
    n = cfg.num_rays
    tri = (t < VERY_FAR) & is_tri
    tid = ident.clamp(0, sc.tri_attr.shape[0] - 1).long()
    taps, tap_rows = [], tr._tap_rows

    def record(table, idx):  # the plain body's row gathers of the atlas
        if table is sc.tex_data:
            taps.append(idx)
        return tap_rows(table, idx)
    tr._tap_rows = record
    try:
        tr._shade_plain(*args)
    finally:
        tr._tap_rows = tap_rows
    k = 4 if cfg.texture_filter == "bilinear" else 1
    lanes = [lane for lane, gate in ((15, sc.has_albedo_tex),
                                     (26, sc.has_normal_maps),
                                     (31, sc.has_rough_maps)) if gate]
    if len(taps) != k * len(lanes):
        raise AssertionError(f"{len(taps)} taps recorded, {k} a map for "
                             f"{len(lanes)} maps")
    rows = [idx[tri & (sc.tri_attr[tid, lane] >= 0)]
            for j, lane in enumerate(lanes) for idx in taps[k * j:k * j + k]]
    used = torch.cat(rows) if rows else torch.zeros(0, dtype=torch.long)
    sectors = int(torch.unique(used.long() // 2).numel())  # 16-byte rows
    tris = int(torch.unique(ident[tri]).numel())
    surface_b = n * (SURFACE_RAY_BYTES + RECORD_BYTES) + tris * (
        TRI_SHADE_ROW_BYTES + TRI_ATTR_READ_BYTES) + sectors * TAP_BYTES
    shade_b = n * (SHADE_READ_BYTES - 1 + RECORD_BYTES + SHADE_WRITE_BYTES)
    both, by = bound_ms(surface_b + shade_b, 0)
    return dict(taps=int(used.numel()), tap_sectors=sectors,
                tri_hits=int(tri.sum()), distinct_tris=tris,
                surface_bound_ms=bound_ms(surface_b, 0)[0],
                shade_bound_ms=bound_ms(shade_b, 0)[0],
                bound_ms=both, bound_by=by)


def textured_at_step(ren, args, reps: int = 20) -> dict:
    """:func:`shade_at_step` for the textured variant: its two kernels
    (``kshade.surface``, then ``kshade.shade_textured`` from the record)
    against the plain body, the slots off counted by what each shaded
    (:data:`TEXTURED_CATEGORIES`), each kernel timed alone with the L2
    evicted and from a trace, the two together, the plain body, and
    :func:`textured_bound`; the kernels' registers and spills."""
    cfg, sc = ren.cfg, ren.scene
    (_, _, sky, sun, rays, t, ident, is_tri, frame, tn) = args

    def surf():
        return kshade.surface(cfg, sc, rays, t, ident, is_tri, frame, tn)
    rec = surf()

    def shade_rest():
        return kshade.shade_textured(cfg, sc, sky, sun, rays, t, ident,
                                     is_tri, frame, rec)

    def both():
        return kshade.shade_textured(cfg, sc, sky, sun, rays, t, ident,
                                     is_tri, frame, surf())
    fused, plain = shade_rest(), tr._shade_plain(*args)
    hit = t < VERY_FAR
    got, n_eq, n_el = shade_mismatches(fused, plain, hit_mask=hit)
    bad = torch.zeros_like(hit)
    for v in shade_bad_slots(fused, plain, hit_mask=hit).values():
        bad |= v
    cats = by_category(textured_categories(sc, t, ident, is_tri, rec), bad)
    n = cfg.num_rays
    regs = build.registers()
    out = dict(variant="textured", filter=cfg.texture_filter, rays=n,
               carried=int(ren.state.n_carried), mismatches=got,
               by_category=cats, float_elements_equal=n_eq,
               float_elements=n_el,
               surface_ms=cuda_ms(surf, reps, cold=True),
               shade_ms=cuda_ms(shade_rest, reps, cold=True),
               ms=cuda_ms(both, reps, cold=True),
               surface_kernel_ms=kernel_ms(surf, SURFACE_KERNELS),
               shade_kernel_ms=kernel_ms(shade_rest, SHADE_TEXTURED_KERNELS),
               plain_ms=cuda_ms(lambda: tr._shade_plain(*args), 5,
                                cold=True),
               library_ms=None,
               registers={k: regs.get(k) for k in (
                   "surface_kernel", "shade_textured_kernel")},
               **textured_bound(args))
    log(f"shade textured ({cfg.texture_filter}) at a step ({n} slots, "
        f"{out['carried']} carried, {out['tri_hits']} triangle hits on "
        f"{out['distinct_tris']} triangles, {out['taps']} taps on "
        f"{out['tap_sectors']} sectors): mismatches {json.dumps(got)}; (slots, slots "
        f"off) by what they shaded {json.dumps(cats)}; float elements bit "
        f"for bit {n_eq}/{n_el}; with the L2 evicted: surface "
        f"{out['surface_ms']:.4f} ms (bound {out['surface_bound_ms']:.4f}), "
        f"shade {out['shade_ms']:.4f} ms (bound "
        f"{out['shade_bound_ms']:.4f}), both {out['ms']:.4f} ms (bound "
        f"{out['bound_ms']:.4f}), plain {out['plain_ms']:.4f} ms; alone "
        f"back to back: surface {fmt_ms(out['surface_kernel_ms'])}, shade "
        f"{fmt_ms(out['shade_kernel_ms'])}; registers "
        f"{json.dumps(out['registers'])}")
    if any(got.values()):
        raise AssertionError(f"the textured shade kernels differ from the "
                             f"plain version: {got}, {cats}")
    return out


@contextlib.contextmanager
def tracer_on(on: bool = True):
    """The program's tracer (``utils.profiling``) on while ``on``, for
    :func:`check_counters`.  Its markers and counters launch outside the
    stage ranges that :func:`stage_split` reads."""
    if on:
        profiling.enable()
    try:
        yield
    finally:
        if on:
            profiling.disable()


def check_counters(snap: dict, n: int, carried0: int, shadow0: int,
                   seen: list, spheres: bool) -> None:
    """The tracer's per-step counters in ``snap`` (``profiling.snapshot()``
    of a run of render steps on one device since ``enable``) against the
    states the steps returned: ``seen`` holds each step's (n_carried,
    shadow_rays) after it, ``carried0`` and ``shadow0`` those before the
    first.  Each step's ``shadow_valid`` must be its ``shadow_rays`` delta,
    ``shadow_slots`` the queue's ``n``, ``survivors`` its ``n_carried``,
    ``flushed`` and ``fresh_rays`` what the queue dropped and topped up,
    ``sphere_kernel`` 2n (extend's queue and connect's) in a scene with
    ``spheres``, else 0; the running totals the rows' sums."""
    steps = snap["steps"]
    if len(steps) != len(seen):
        raise AssertionError(f"the tracer holds {len(steps)} steps, "
                             f"{len(seen)} ran")
    carried, shadow = carried0, shadow0
    for rec, (c, sh) in zip(steps, seen):
        got = rec["counts"]
        want = dict(fresh_rays=n - carried, survivors=c, flushed=n - c,
                    shadow_slots=n, shadow_valid=sh - shadow,
                    sphere_kernel=2 * n if spheres else 0)
        bad = {k: (got[k], v) for k, v in want.items() if got[k] != v}
        if bad:
            raise AssertionError(f"tracer step {rec['step']}: counters "
                                 f"(counted, from the state) {bad}")
        carried, shadow = c, sh
    (totals,) = snap["counters"].values()
    sums = {k: sum(r["counts"][k] for r in steps) for k in totals}
    if totals != sums:
        raise AssertionError(f"tracer totals {totals} are not the sums of "
                             f"its rows {sums}")


def trace_ring_check(steps: int = 40, slots: int = 16) -> None:
    """The tracer's kernels (``csrc/common.cu``: ``trace_marker<K>``,
    ``trace_count``) against their plain versions (the CPU branches of
    ``utils.profiling``) on the same values: ``steps`` steps into rings
    of ``slots`` rows, a step a raygen marker, the end marker (which
    advances the step), a row of counter values (random int64 up to 2^40)
    and the image marker into the row just ended.  The counter rows, the
    totals and the step counters must be equal, the markers fill the same
    cells, and each row's device clocks must not fall."""
    g = torch.Generator().manual_seed(17)
    rings = [profiling._Ring(torch.device(d), slots) for d in ("cpu", DEV)]
    for _ in range(steps):
        v = torch.randint(0, 1 << 40, (len(profiling.COUNTERS),),
                          generator=g, dtype=torch.int64)
        for r in rings:
            profiling._launch_marker(r.marks, r.step, 0)
            profiling._launch_marker(r.marks, r.step, profiling.END,
                                     advance=True)
            profiling._launch_count(r, v.to(r.device))
            profiling._launch_marker(r.marks, r.step, profiling.IMAGE,
                                     back=1)
    torch.cuda.synchronize()
    cpu, dev = rings
    for what in ("counts", "total", "step"):
        if not torch.equal(getattr(cpu, what), getattr(dev, what).cpu()):
            raise AssertionError(f"trace_count: the device ring's {what} "
                                 "is not the plain version's")
    marks = dev.marks.cpu()
    if not torch.equal(cpu.marks != 0, marks != 0):
        raise AssertionError("trace_marker filled other cells than the "
                             "plain version")
    cols = [0, profiling.END, profiling.IMAGE]
    if not bool((marks[:, cols].diff(dim=1) >= 0).all()):
        raise AssertionError("trace_marker: a row's device clock fell")
    log(f"tracer kernels: {steps} steps on a {slots}-step ring, counters, "
        "totals, step and marker cells equal to the plain version")


def stage_split(trace_path: Path, steps: int) -> tuple[dict, float, dict]:
    """Device ms per step of each stage of render_step, from a profiler
    trace: every kernel, copy and memset is charged to the stage whose
    ``record_function`` range was open on the host when it was launched.
    Returns (split, busy ms per step, device ops per step of each stage);
    ``split["other"]`` is device time launched outside the stage
    ranges."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    dev = {e["args"]["correlation"]: e["dur"] for e in events
           if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")}
    spans = [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
             if e.get("cat") == "user_annotation" and e["name"] in STAGES]
    split = dict.fromkeys(STAGES + ("other",), 0.0)
    ops = dict.fromkeys(STAGES + ("other",), 0)
    for e in events:
        if e.get("cat") not in ("cuda_runtime", "cuda_driver"):
            continue
        us = dev.get(e.get("args", {}).get("correlation"))
        if us is None:
            continue
        stage = next((name for a, b, name in spans if a <= e["ts"] <= b),
                     "other")
        split[stage] += us
        ops[stage] += 1
    busy = sum(dev.values())
    return ({k: v / 1e3 / steps for k, v in split.items()},
            busy / 1e3 / steps, {k: v / steps for k, v in ops.items()})


LAUNCH_KEYS = ("traverse", "traverse_wave", "accumulate", "stream", "shade")
NORMALS_KEYS = ("traverse_normals", "traverse_wave_normals")
MOMENT2_KEYS = ("accumulate_moment2",)
# the textured variant's surface and shade kernels
TEXTURED_KEYS = ("shade_surface", "shade_textured")


def reset_launches(*renderers) -> None:
    """Every wrapper's launch counter to 0, and the replay counts of the
    captured ``renderers``."""
    kernels.set_launch_counts(dict.fromkeys(kernels.launch_counts(), 0))
    for ren in renderers:
        ren.replayed_steps = 0
        ren.replayed_launches.clear()


def read_launches(*renderers, keys=LAUNCH_KEYS) -> dict:
    """The kernel launches since the reset: the wrappers' counters (their
    eager launches) plus the launches that the ``renderers``' graph
    replays made (a replay adds nothing to the counters)."""
    counts = kernels.launch_counts()
    return {k: counts[k] + sum(ren.replayed_launches.get(k, 0)
                               for ren in renderers) for k in keys}


def device_busy(trace_path: Path, steps: int) -> tuple[float, float]:
    """(device ms, device ops) per step of a profiler trace: every kernel,
    copy and memset record, whether launched alone or by a graph replay
    (whose kernels share the replay's correlation id)."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    dev = [e["dur"] for e in events
           if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    return sum(dev) / 1e3 / steps, len(dev) / steps


def check_replays(ren, steps: int) -> None:
    """A captured renderer's ``steps`` since the reset: all replayed but
    the capture's eager warm-up, if it fell among them (the only step that
    launches the accumulation from Python, with or without moment2)."""
    counts = kernels.launch_counts()
    eager = counts["accumulate"] + counts["accumulate_moment2"]
    if eager > 1 or ren.replayed_steps != steps - eager:
        raise AssertionError(f"{ren.replayed_steps} of {steps} steps "
                             f"replayed, {eager} run eagerly")


def warm_profiler() -> None:
    """The profiler's first session sets up the device tracing; keep that
    cost out of the first window."""
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.ones(1, device=DEV).add_(1)
        torch.cuda.synchronize()


def phase3(ren, poses_run=(0, 1, 2), label: str = "",
           camera=camera_for_pose):
    """The main path at full size (or, with a ``label``, another scene's
    path), with the traversal generation that ``ren.cfg.packet_kernel_mode``
    selects, eager or captured as ``ren.captured`` says: for each pose 4
    warm-up steps, 8 steps timed with CUDA events, then 2 steps under the
    profiler for the device's busy time and idle share, and for an eager
    renderer the per-stage device-time split (a graph replay has no
    stages) and the tracer's counters of those 2 steps against the
    states they returned (:func:`check_counters`).  ``camera(i)``: pose
    i's camera.  Under ``track_variance`` or adaptive sampling the
    accumulation is the moment2 mode's launch."""
    cfg = ren.cfg
    wave = tr._pick_wave(cfg)
    tag = label + ("wave" if wave else "mono") \
        + ("-captured" if ren.captured else "")
    TRACE_DIR.mkdir(parents=True, exist_ok=True)
    warm_profiler()
    reset_launches(ren)
    total_steps = 0
    poses = []
    for i in poses_run:
        cam = camera(i)
        ended = torch.zeros((), dtype=torch.int64, device=DEV)

        def run(steps, cam=cam, ended=ended, seen=None):
            for _ in range(steps):
                st = ren.step(cam, 1)
                ended.add_(cfg.num_rays - st.n_carried)
                if seen is not None:  # an eager step's own tensors
                    seen.append((st.n_carried, st.shadow_rays))

        run(4)  # warm-up
        torch.cuda.synchronize()
        shadow0 = int(ren.state.shadow_rays)
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0 = time.perf_counter()
        a.record()
        run(8)
        b.record()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / 8
        ms = a.elapsed_time(b) / 8
        shadow_n = int(ren.state.shadow_rays) - shadow0
        carried1 = int(ren.state.n_carried)

        trace = TRACE_DIR / f"trace_{tag}_pose{i}.json"
        seen = None if ren.captured else []
        with tracer_on(not ren.captured), \
                profile(activities=[ProfilerActivity.CPU,
                                    ProfilerActivity.CUDA]) as prof:
            a.record()
            run(2, seen=seen)
            b.record()
            torch.cuda.synchronize()
        if seen is not None:
            check_counters(profiling.snapshot(), cfg.num_rays, carried1,
                           shadow0 + shadow_n,
                           [(int(c), int(sh)) for c, sh in seen],
                           spheres=ren.scene.n_spheres > 0)
        prof.export_chrome_trace(str(trace))
        window_ms = a.elapsed_time(b) / 2
        busy_ms, n_ops = device_busy(trace, 2)
        idle = 1.0 - busy_ms / window_ms
        split = ops = None
        if not ren.captured:
            split, busy_ms, ops = stage_split(trace, 2)
            idle = 1.0 - busy_ms / window_ms
            if not all(split[s] > 0 for s in STAGES):
                raise AssertionError(f"pose {i}: a stage ran nothing on the "
                                     f"device: {split}")
            if ops["accumulate"] != 1:
                raise AssertionError(f"pose {i}: the accumulate stage ran "
                                     f"{ops['accumulate']} device ops a "
                                     "step, not its one kernel")
        total_steps += 14

        acc = ren.state.accum
        if not bool(torch.isfinite(acc).all()):
            raise AssertionError(f"pose {i}: accumulation is not finite")
        counted = float(acc[:, 3].double().sum())
        if counted != float(ended):
            raise AssertionError(f"pose {i}: {counted} paths counted, "
                                 f"{int(ended)} ended")
        mr = mrays_per_s(cfg.num_rays, ms, shadow_n, 8)
        poses.append(dict(pose=i, mode=tag, ms_per_step=ms,
                          wall_ms_per_step=wall_ms,
                          mrays_per_s=mr, shadow_rays_per_step=shadow_n / 8,
                          paths_counted=int(counted),
                          profiled_ms_per_step=window_ms,
                          device_busy_ms_per_step=busy_ms, idle_share=idle,
                          device_split_ms=split, device_ops_per_step=ops,
                          device_ops_total_per_step=n_ops))
        log(f"phase 3 {tag} pose {i}: {ms:.3f} ms/step (host {wall_ms:.3f}), "
            f"{mr:.3f} Mrays/s, {shadow_n / 8:.0f} shadow rays/step, "
            f"{int(counted)} paths counted = ended")
        log(f"phase 3 {tag} pose {i} profiled: {window_ms:.3f} ms/step, "
            f"device busy {busy_ms:.3f} ms (idle {idle:.3f}), {n_ops:g} "
            "device ops a step" + ("" if split is None else "; device ms "
            + " ".join(f"{k} {v:.3f}" for k, v in split.items())
            + "; device ops a step " + " ".join(f"{k} {v:g}"
                                                for k, v in ops.items())))
    moments = tr._moments(cfg)
    kind = kshade.variant(cfg, ren.scene, ren.device)
    textured = kind == kshade.TEXTURED
    keys = LAUNCH_KEYS + SPHERE_KEYS + (MOMENT2_KEYS if moments else ()) \
        + (TEXTURED_KEYS if textured else ())
    launches = read_launches(ren, keys=keys)
    if ren.captured:
        check_replays(ren, total_steps)
    log(f"phase 3 {tag} launches over {total_steps} steps: {launches}"
        + (f" ({ren.replayed_steps} steps replayed)" if ren.captured
           else ""))
    want = {"traverse": 0 if wave else 2 * total_steps,
            "traverse_wave": 2 * total_steps if wave else 0,
            "accumulate": 0 if moments else total_steps, "stream": 0,
            # the base shade kernel, the textured variant's two kernels,
            # or the plain body
            "shade": total_steps if kind == kshade.BASE else 0}
    # the sphere kernel in extend and connect, unless the scene has none
    want.update(dict.fromkeys(SPHERE_KEYS, total_steps
                              if ren.scene.n_spheres else 0))
    if textured:
        want.update(dict.fromkeys(TEXTURED_KEYS, total_steps))
    if moments:
        want["accumulate_moment2"] = total_steps
    if launches != want:
        raise AssertionError(f"main path did not run through the kernels: "
                             f"{launches}, expected {want}")
    return poses, launches


def compare_in_step(mono: list, wave: list) -> None:
    """The two generations' in-step numbers side by side, stage by stage."""
    for m, w in zip(mono, wave):
        cols = " ".join(f"{k} {m['device_split_ms'][k]:.3f}/"
                        f"{w['device_split_ms'][k]:.3f}"
                        for k in ("extend", "connect", "shade"))
        log(f"in-step pose {m['pose']} mono/wave: ms/step "
            f"{m['ms_per_step']:.3f}/{w['ms_per_step']:.3f}, device busy "
            f"{m['device_busy_ms_per_step']:.3f}/"
            f"{w['device_busy_ms_per_step']:.3f}, device ms {cols}")


def compare_captured(eager: list, captured: list) -> None:
    """The main cell eager against captured, pose by pose."""
    for e, c in zip(eager, captured):
        log(f"main cell pose {e['pose']} eager/captured: ms/step "
            f"{e['ms_per_step']:.3f}/{c['ms_per_step']:.3f}, Mrays/s "
            f"{e['mrays_per_s']:.3f}/{c['mrays_per_s']:.3f}, device busy "
            f"{e['device_busy_ms_per_step']:.3f}/"
            f"{c['device_busy_ms_per_step']:.3f} ms, idle "
            f"{e['idle_share']:.3f}/{c['idle_share']:.3f}, device ops "
            f"{e['device_ops_total_per_step']:g}/"
            f"{c['device_ops_total_per_step']:g}")


def check_queue(what: str, o, d, t, tables, bvh, closest: bool,
                reps: int = 5, stream: bool = True) -> dict:
    """Both depth-first traversal kernels against the plain walk on one
    queue of the main path, and on a closest-hit queue the stream kernel
    (:func:`check_stream`, unless ``stream`` is False): checked with the
    tie rule (closest) or exactly
    (any hit),
    timed with CUDA events, with the bound from the work the plain walk
    counts on these rays (distinct node and triangle records read, boxes
    and triangles tested), one bound for all three kernels; the stream
    kernel's frontier floor beside it.
    The plain walk runs once.  A shadow ray whose max distance is at most
    2 EPSILON cannot be occluded: the plain walk skips it, and the bound
    reads its max distance and writes its flag but not its origin and
    direction."""
    stats = {}
    n = o.shape[0]
    if closest:
        (t_p, id_p), plain_ms = timed_once(
            lambda: plain_trav.closest_hit(o, d, bvh, t, stats=stats))
        live, live_mask = n, torch.ones_like(t, dtype=torch.bool)
    else:
        walk = t > 2.0 * EPSILON
        occ_p, plain_ms = timed_once(
            lambda: plain_trav.any_hit(o, d, t, bvh, active=walk,
                                       stats=stats))
        live, live_mask = int(walk.sum()), walk
    counts = simt_counts(stats["row_visits"], live_mask)
    log(f"{what} counts: {stats['box_tests'] / max(live, 1):.2f} box tests "
        f"and {counts['mean_trips']:.2f} fat rows a live ray (most "
        f"{int(stats['visits'].max())} and {counts['max_trips']}); SIMT "
        f"efficiency {counts['simt_all_slots']:.3f} over all slots in queue "
        f"order, {counts['simt_live_packed']:.3f} over the live slots "
        f"packed")
    rows = int(stats["rows"].sum()) + int(not bool(stats["rows"][0]))
    tris = stats["tris_read"]
    ray_bytes = live * (3 + 3) * 4 + n * 4 + n * (8 if closest else 4)
    n_bytes = ray_bytes + rows * NODE_BYTES + tris * TRI_BYTES
    n_ops = SLAB_OPS * stats["box_tests"] + MT_OPS * stats["tri_tests"]
    bnd, by = bound_ms(n_bytes, n_ops)
    out = dict(rays=n, live_rays=live, plain_ms=plain_ms, rows_read=rows,
               tris_read=tris, box_tests=stats["box_tests"],
               tri_tests=stats["tri_tests"], bytes=n_bytes, ops=n_ops,
               bound_ms=bnd, bound_by=by, **counts)
    for gen, wave in GENERATIONS:
        if closest:
            def fn(wave=wave):
                return ktrav.closest_hit_packets(o, d, tables, t, wave=wave)
            t_k, id_k = fn()
            res = check_closest(f"{what} {gen}", t_k, id_k, t_p, id_p)
            out[f"{gen}_ids"] = id_k
        else:
            def fn(wave=wave):
                return ktrav.any_hit_packets(o, d, t, tables, wave=wave)
            res = check_any(f"{what} {gen}", fn(), occ_p)
        out[gen] = dict(res, ms=cuda_ms(fn, reps))
    stream = stream and closest
    if closest:
        out["wave"]["ties_vs_mono"] = int(
            (out.pop("wave_ids") != out.pop("mono_ids")).sum())
    if stream:
        out["stream"] = check_stream(what, o, d, t, tables, t_p, id_p,
                                     reps=reps)
    log(f"{what} ({n} rays, {live} walked): mono {out['mono']['ms']:.4f} "
        f"ms, wave {out['wave']['ms']:.4f} ms"
        + (f", stream {out['stream']['ms']:.4f} ms" if stream else "")
        + f", plain {plain_ms:.3f} ms; bound "
        f"{bnd:.4f} ms ({by}: {rows} rows and {tris} triangles read, "
        f"{n_bytes / 1e6:.1f} MB, {n_ops / 1e9:.3f} G operations)"
        + (f"; the stream kernel's frontier floor "
           f"{out['stream']['frontier_floor_ms']:.4f} ms" if stream else ""))
    return out


def simt_counts(row_visits, live) -> dict:
    """What the order of a queue costs a kernel that pins one ray to one
    lane: a live ray takes one loop trip per fat row it reads (the
    root's always), a warp as many as its longest ray.  Returns the mean
    and the most trips of a live ray and the SIMT efficiency,
    sum(trips) / (32 * sum over warps of the most trips), over all slots
    in queue order and over the live slots packed densely."""
    trips = torch.where(live, row_visits.clamp(min=1),
                        torch.zeros_like(row_visits))

    def efficiency(v):
        if not v.numel():
            return 1.0
        pad = (-v.numel()) % 32
        warps = torch.nn.functional.pad(v, (0, pad)).view(-1, 32)
        return float(v.sum()) / (32.0 * float(warps.amax(1).sum()))

    packed = trips[live]
    return dict(mean_trips=float(packed.double().mean()) if packed.numel()
                else 0.0,
                max_trips=int(packed.max()) if packed.numel() else 0,
                simt_all_slots=efficiency(trips),
                simt_live_packed=efficiency(packed))


def kernels_at_slice(ren, stream: bool = True, label: str = "slice",
                     camera=camera_for_pose) -> dict:
    """The traversal kernels against the plain walk, compared and timed
    on the inputs the path gives them in pose 0's next step (the stream
    kernel on the two closest-hit queues unless ``stream`` is False): the
    extend queue seeded with the sphere pass's t (VERY_FAR everywhere in a
    scene without spheres), the shadow queue that shade makes from those
    hits, and the AOV pass's pixel-centre primaries with their sphere t;
    and the accumulation on the queue of the step before.  ``camera(0)``:
    pose 0's camera; under motion blur the queue's fresh rays lerp from
    the renderer's previous pose, as the step's do."""
    cfg, sc = ren.cfg, ren.scene
    cam = camera(0)
    ren.step(cam, 1)
    accum = accum_at_step(ren)
    camd = cam.to_device(cfg, DEV)
    prev = None
    if ren._blur:
        prev = ren._cam_prev if ren.captured else ren._prev_cam
    rays = tr.merge_queue(cfg, ren.state, camd, prev)
    o, d = rays["origin"], rays["direction"]
    t_sph, sph_id = tr.sphere_pass(o, d, sc)
    extend = check_queue(f"{label} extend closest", o, d, t_sph, ren.tables,
                         sc.bvh, closest=True, stream=stream)
    extend["t_init_all_far"] = bool((t_sph >= VERY_FAR).all())
    # the same rays without the sphere pass's t_init: how much the spheres
    # (the ground sphere above all) prune the BVH walk
    unseeded = {gen: cuda_ms(lambda wave=wave: ktrav.closest_hit_packets(
        o, d, ren.tables, wave=wave), 5) for gen, wave in GENERATIONS}
    log(f"{label} extend without the sphere t_init: mono "
        f"{unseeded['mono']:.4f} ms, wave {unseeded['wave']:.4f} ms")

    t, tri_id = ktrav.closest_hit_packets(o, d, ren.tables, t_sph)
    is_tri = tri_id >= 0
    _, _, _, shadow = tr._shade(
        cfg, sc, ren.sky_params, ren.sun_dir, rays, t,
        torch.where(is_tri, tri_id, sph_id), is_tri, ren.state.frame)
    valid = shadow["valid"]  # connect's inputs: invalid rays get maxd 0
    maxd = torch.where(valid, shadow["max_dist"],
                       torch.zeros_like(shadow["max_dist"]))
    so, sd = shadow["origin"].contiguous(), shadow["direction"].contiguous()
    # what the queue aims at: the sun (or the envmap) and directional
    # lights at infinity, a sphere, a LIGHT triangle or a point or spot
    # light at a finite distance
    far = shadow["max_dist"] >= VERY_FAR
    targets = dict(rays=int(valid.numel()), valid=int(valid.sum()),
                   to_infinity=int((valid & far).sum()),
                   finite=int((valid & ~far).sum()))
    log(f"{label} shadow queue targets: {targets}")
    connect = check_queue(
        f"{label} connect any hit ({targets['valid']} valid)", so, sd, maxd,
        ren.tables, sc.bvh, closest=False)
    connect["targets"] = targets

    ao, ad = tr.aov_primaries(camd, cfg)
    a_sph, _ = tr.sphere_pass(ao, ad, sc)
    aov = check_queue(f"{label} AOV primaries closest", ao, ad, a_sph,
                      ren.tables, sc.bvh, closest=True, stream=stream)
    return dict(extend=dict(extend, unseeded_ms=unseeded), connect=connect,
                aov=aov, accumulate=accum)


def display_path(scene, tables, cfg: RenderConfig, steps: int = 8) -> dict:
    """The denoised display path with the wave kernel: ``steps`` steps at
    pose 0, then ``image()`` (AOV pass, à-trous denoiser, bloom, tone
    map), timed whole and by part with CUDA events, eagerly
    (``fuse_step_chains="off"``); then the same on a captured renderer,
    whose state and ``image()`` (and ``image(uint8=True)``) must equal
    the eager ones bit for bit, with ``image()`` timed eager against
    captured, replay against replay."""
    ren = tr.Renderer(scene, dataclasses.replace(cfg, fuse_step_chains="off"),
                      tables=tables)
    cam = camera_for_pose(0)
    reset_launches()
    ren.step(cam, steps)
    torch.cuda.synchronize()
    stepped = read_launches()
    img, image_ms = timed_once(ren.image)
    launches = read_launches()
    aov_launches = launches["traverse_wave"] - stepped["traverse_wave"]
    log(f"display path launches: {steps} steps {stepped}, image() "
        f"{aov_launches} wave launch(es)")
    shade = steps if kshade.variant(cfg, scene, DEV) else 0
    if stepped != {"traverse": 0, "traverse_wave": 2 * steps,
                   "accumulate": steps, "stream": 0, "shade": shade} \
            or aov_launches != 1 \
            or launches["traverse"] != 0:
        raise AssertionError(f"the display path did not run through the "
                             f"kernels: {stepped} then {launches}")
    if tuple(img.shape) != (cfg.height, cfg.width, 3) \
            or not bool(torch.isfinite(img).all()) \
            or float(img.min()) < 0.0 or float(img.max()) > 1.0:
        raise AssertionError("the display image is not finite in [0, 1]")

    aovs = ren.aovs()
    mean = ren.radiance()
    aov_ms = cuda_ms(lambda: tr.render_aovs(ren.scene, ren._last_cam,
                                            ren.cfg, ren.tables), 3)
    dn_ms = cuda_ms(lambda: atrous_denoise(
        mean, aovs["albedo"], aovs["normal"], aovs["depth"],
        iterations=cfg.denoise_iterations), 3)
    bloom_ms = cuda_ms(lambda: bloom(mean, cfg.bloom_strength,
                                     cfg.bloom_threshold, cfg.bloom_radius), 3)
    plain = ren.image(denoise=False)
    changed = float((img - plain).abs().mean())
    log(f"display path {cfg.width}x{cfg.height}: image() {image_ms:.3f} ms "
        f"(AOV pass {aov_ms:.3f} ms, denoiser {dn_ms:.3f} ms, bloom "
        f"{bloom_ms:.3f} ms); mean |denoised - raw| {changed:.4f}")
    img8 = ren.image(uint8=True)
    eager_ms = cuda_ms(ren.image, 5)  # the AOVs cached: the resolve alone

    # the same path captured
    cap = tr.Renderer(scene, dataclasses.replace(cfg,
                                                 fuse_step_chains="auto"),
                      tables=tables)
    reset_launches(cap)
    cap.step(cam, steps)
    got = cap.image().clone()
    got8 = cap.image(uint8=True).clone()
    torch.cuda.synchronize()
    cap_launches = read_launches(cap)
    check_replays(cap, steps)
    same_state = states_equal(ren.state, cap.state)
    if not (same_state and same_bits(got, img)
            and torch.equal(got8, img8)):
        raise AssertionError(f"the captured display path differs from the "
                             f"eager one: state equal {same_state}, image "
                             f"equal {same_bits(got, img)}, uint8 equal "
                             f"{torch.equal(got8, img8)}")
    replay_ms = cuda_ms(cap.image, 5)
    log(f"display path captured: {steps} steps, image() and image(uint8="
        f"True) bit for bit the eager ones; launches {cap_launches} "
        f"({cap.replayed_steps} steps replayed); image() with the AOVs "
        f"cached: eager {eager_ms:.3f} ms, captured {replay_ms:.3f} ms")
    return dict(image_ms=image_ms, aov_ms=aov_ms, denoise_ms=dn_ms,
                bloom_ms=bloom_ms, launches=launches,
                mean_change=changed,
                captured=dict(launches=cap_launches, image_equal=True,
                              eager_image_ms=eager_ms,
                              captured_image_ms=replay_ms))


STATE_FIELDS = [f.name for f in dataclasses.fields(tr.RenderState)]


def states_equal(a, b) -> bool:
    """Every RenderState field equal bit for bit."""
    return all(torch.equal(getattr(a, k).view(torch.uint8)
                           if getattr(a, k).dtype == torch.float32
                           else getattr(a, k),
                           getattr(b, k).view(torch.uint8)
                           if getattr(b, k).dtype == torch.float32
                           else getattr(b, k)) for k in STATE_FIELDS)


def captured_step(scene, tables, cfg: RenderConfig,
                  poses_run=(0, 1, 2), chain: bool = True,
                  label: str = "") -> dict:
    """The main cell captured (``fuse_step_chains="auto"``) beside the
    eager step (``"off"``): both renderers step 3 times at pose 0, 2 at
    pose 1, then 1 after a sun change, and every RenderState field must
    then be equal bit for bit; then phase 3 on the captured renderer (the
    eager numbers are phase 3's own) and the graph of one step against a
    chain of four, 8 steps a window."""
    eager = tr.Renderer(scene, dataclasses.replace(cfg,
                                                   fuse_step_chains="off"),
                        tables=tables)
    cap = tr.Renderer(scene, dataclasses.replace(cfg,
                                                 fuse_step_chains="auto"),
                      tables=tables)
    if eager.captured or not cap.captured:
        raise AssertionError("fuse_step_chains did not select the step")
    reset_launches(cap)
    for ren in (eager, cap):
        ren.step(camera_for_pose(0), 3)
        ren.step(camera_for_pose(1), 2)
        ren.set_sun((0.2, 0.35))
        ren.step(camera_for_pose(1), 1)
    torch.cuda.synchronize()
    if not states_equal(eager.state, cap.state):
        bad = [k for k in STATE_FIELDS if not torch.equal(
            getattr(eager.state, k), getattr(cap.state, k))]
        raise AssertionError(f"captured and eager states differ after 6 "
                             f"steps in: {bad}")
    log(f"{label}captured step: bit for bit the eager step on every "
        f"RenderState field after 6 steps (a pose and a sun change between); "
        f"{cap.replayed_steps} replayed, launches by the replays "
        f"{cap.replayed_launches}")
    del eager
    cap.set_sun((0.05, 0.3))
    poses, launches = phase3(cap, poses_run, label)
    if not chain:
        return dict(equal_after_6=True, poses=poses, launches=launches)
    # the renderer's graph of one step against a graph of four (the JAX
    # package's _CHAIN_LEN), made here on the renderer's static buffers
    cam = camera_for_pose(0)
    cap.step(cam, 1)
    four = tr._Graph(lambda: [cap._static_step() for _ in range(4)], DEV,
                     "a chain of four render steps")
    chains = {1: cuda_ms(lambda: cap.step(cam, 8), 3) / 8,
              4: cuda_ms(lambda: [four.graph.replay() for _ in range(2)],
                         3) / 8}
    del four
    log(f"captured step: a graph of one step {chains[1]:.3f} ms/step, a "
        f"chain of four {chains[4]:.3f} ms/step (8 steps a window)")
    return dict(equal_after_6=True, poses=poses, launches=launches,
                chain_ms_per_step={str(k): v for k, v in chains.items()})


def normals_at_extend(ren, reps: int = 5, min_hits: float = 0.2,
                      max_steps: int = 16) -> dict:
    """The normals output of both depth-first kernels on an extend queue
    of ``ren`` at pose 0 (the interactive preset's, on the main scene):
    the first step's queue whose rays hit a triangle ``min_hits`` of the
    time (a 131,072-ray queue covers a band of the image, which starts in
    the sky), or the last of ``max_steps``.  t and ids equal to the same
    kernel's without normals,
    the normals bit for bit ``hit_normals`` of its own ids (the plain
    version's arithmetic), and against the plain walk with normals: ids
    with the tie rule, normals bit for bit where the ids agree.  Timed
    with and without normals, beside the plain walk and a bound: the
    extend bound plus the normals written (12 B a ray) and 9 operations
    a hit."""
    cfg, sc = ren.cfg, ren.scene
    cam = camera_for_pose(0)
    for steps in range(1, max_steps + 1):
        ren.step(cam, 1)
        rays = tr.merge_queue(cfg, ren.state, cam.to_device(cfg, DEV))
        o, d = rays["origin"], rays["direction"]
        t_sph, _ = tr.sphere_pass(o, d, sc)
        _, hit_id = ktrav.closest_hit_packets(o, d, ren.tables, t_sph)
        if float((hit_id >= 0).float().mean()) >= min_hits:
            break
    stats = {}
    (t_p, id_p, n_p), plain_ms = timed_once(
        lambda: plain_trav.closest_hit(o, d, sc.bvh, t_sph, stats=stats,
                                       normals=True))
    n = o.shape[0]
    hits = int((id_p >= 0).sum())
    rows = int(stats["rows"].sum()) + int(not bool(stats["rows"][0]))
    n_bytes = n * (3 + 3 + 1) * 4 + n * 8 + n * 12 + rows * NODE_BYTES \
        + stats["tris_read"] * TRI_BYTES
    bnd, by = bound_ms(n_bytes, SLAB_OPS * stats["box_tests"]
                       + MT_OPS * stats["tri_tests"] + 9 * hits)
    out = dict(rays=n, hits=hits, steps=steps, plain_ms=plain_ms,
               bound_ms=bnd, bound_by=by)
    for gen, wave in GENERATIONS:
        t0, id0 = ktrav.closest_hit_packets(o, d, ren.tables, t_sph,
                                            wave=wave)
        t1, id1, n1 = ktrav.closest_hit_packets(o, d, ren.tables, t_sph,
                                                wave=wave, normals=True)
        own = plain_trav.hit_normals(sc.bvh.tri_packed, id1)
        agree = id1 == id_p
        if not (torch.equal(id0, id1) and same_bits(t0, t1)
                and same_bits(n1, own)
                and same_bits(n1[agree], n_p[agree])):
            raise AssertionError(
                f"{gen} normals: ids equal {torch.equal(id0, id1)}, t equal "
                f"{same_bits(t0, t1)}, normals = hit_normals "
                f"{same_bits(n1, own)}, = the plain walk's where the ids "
                f"agree {same_bits(n1[agree], n_p[agree])}")
        res = check_closest(f"preset extend {gen} with normals", t1, id1,
                            t_p, id_p)
        ms = cuda_ms(lambda wave=wave: ktrav.closest_hit_packets(
            o, d, ren.tables, t_sph, wave=wave, normals=True), reps)
        ms_off = cuda_ms(lambda wave=wave: ktrav.closest_hit_packets(
            o, d, ren.tables, t_sph, wave=wave), reps)
        err = float((n1 - own).abs().max()) if n else 0.0
        out[gen] = dict(res, normals_max_abs_err=err, ms=ms,
                        ms_without_normals=ms_off)
        log(f"preset extend {gen}, step {steps}'s queue: normals bit for "
            f"bit the plain version ({hits} of {n} rays hit a triangle), t "
            f"and ids those of the "
            f"kernel without normals; {ms:.4f} ms with normals, "
            f"{ms_off:.4f} ms without, plain walk {plain_ms:.3f} ms, bound "
            f"{bnd:.4f} ms ({by})")
    return out


def shade_split(ren, frames: int = 2) -> dict:
    """An eager fly-through renderer's per-stage device split over
    ``frames`` more frames (one step and one image each), from a profiler
    trace: the shade stage's ms and device ops a step."""
    cam = camera_for_pose(0)
    interactive.frame(ren, cam, 0)
    trace = TRACE_DIR / "trace_flythrough.json"
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(frames):
            interactive.frame(ren, cam, i + 1)
        torch.cuda.synchronize()
    prof.export_chrome_trace(str(trace))
    split, busy, ops = stage_split(trace, frames)
    return dict(split_ms=split, ops=ops, busy_ms=busy)


def flythrough(scene, tables, cfg: RenderConfig, n_frames: int = 40,
               profiled: int = 8) -> dict:
    """The interactive fly-through (``bench/interactive.py``) at
    ``cfg``'s size, the camera moving every frame from pose 0, then
    still: ``use_kernel_normals`` and ``fuse_step_chains`` each on and
    off, and the wave kernel with both on.  Per run: ms a frame (mean,
    median, min) and FPS for both cameras; ``profiled`` more moving frames
    under the profiler for the device's busy time and idle share; the
    launches, replays counted, which must be the steps'; for the eager
    runs, the shade stage's ms and ops from their trace."""
    out = {}
    runs = [("normals-on", "on", "auto", "auto"),
            ("normals-on", "on", "off", "auto"),
            ("normals-off", "off", "auto", "auto"),
            ("normals-off", "off", "off", "auto"),
            ("normals-on-wave", "on", "auto", "wave")]
    TRACE_DIR.mkdir(parents=True, exist_ok=True)
    warm_profiler()
    for name, kn, fuse, mode in runs:
        c = dataclasses.replace(cfg, use_kernel_normals=kn,
                                fuse_step_chains=fuse,
                                packet_kernel_mode=mode)
        reset_launches()
        res = interactive.run_interactive(scene, c, n_frames=n_frames,
                                          tables=tables)
        ren = res.pop("renderer")
        cam = camera_for_pose(0)
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        trace = TRACE_DIR / f"trace_fly_{name}_{fuse}.json"
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            a.record()
            t0 = time.perf_counter()
            for i in range(profiled):
                interactive.frame(ren, cam, i)
            b.record()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3 / profiled
        prof.export_chrome_trace(str(trace))
        window = a.elapsed_time(b) / profiled
        busy, n_ops = device_busy(trace, profiled)
        steps = 2 * (interactive.WARMUP_FRAMES + n_frames) + profiled
        launches = read_launches(ren, keys=LAUNCH_KEYS + NORMALS_KEYS)
        gen = "traverse_wave" if mode == "wave" else "traverse"
        want_normals = steps if kn == "on" else 0
        if launches["accumulate"] != steps \
                or launches[gen] != 2 * steps \
                or launches[f"{gen}_normals"] != want_normals:
            raise AssertionError(f"fly-through {name} {fuse}: launches "
                                 f"{launches} over {steps} steps")
        if ren.captured:
            check_replays(ren, steps)
        elif not (n_ops and busy > 0):
            raise AssertionError("the eager fly-through ran nothing traced")
        run = dict(res, wall_ms_per_frame=wall, window_ms_per_frame=window,
                   device_busy_ms_per_frame=busy,
                   idle_share=1.0 - busy / window, device_ops_per_frame=n_ops,
                   launches=launches, steps=steps,
                   replayed_steps=ren.replayed_steps, captured=ren.captured)
        if not ren.captured and mode == "auto":
            run["eager_split"] = shade_split(ren)
        out[f"{name}-{fuse}"] = run
        img = ren.image(uint8=True)
        if tuple(img.shape) != (c.height, c.width, 3):
            raise AssertionError(f"fly-through image shape {img.shape}")
        log(f"fly-through {name} fuse={fuse} ({c.width}x{c.height}, "
            f"{c.num_rays} rays): moving {res['moving']['mean_ms']:.3f} "
            f"ms/frame (median {res['moving']['median_ms']:.3f}, min "
            f"{res['moving']['min_ms']:.3f}, {res['moving']['fps']:.1f} "
            f"FPS), still {res['still']['mean_ms']:.3f} ms/frame "
            f"({res['still']['fps']:.1f} FPS); profiled {window:.3f} ms/"
            f"frame (host {wall:.3f}), device busy {busy:.3f} ms (idle "
            f"{1.0 - busy / window:.3f}), {n_ops:g} device ops a frame; "
            f"launches {launches}, {ren.replayed_steps} of {steps} steps "
            "replayed" + ("" if "eager_split" not in run else
                          f"; eager shade {run['eager_split']['split_ms']['shade']:.3f} ms, "
                          f"{run['eager_split']['ops']['shade']:g} ops a step"))
        del ren
    return out


def phase4(denoise_wave: bool = False, light_case=None) -> float:
    """The card against the CPU at small size: the accumulation's
    resolve, or with ``denoise_wave`` the denoised display image rendered
    with the wave kernel on the card; with ``light_case`` = (name, spec)
    on that lights configuration (:func:`light_scene`) with at most 64
    LIGHT triangles and a 64x128 sky."""
    kw = dict(denoise="on", packet_kernel_mode="wave") if denoise_wave else {}
    v0, v1, v2 = terrain(n_quads=48, towers=4)
    scene = Scene.from_triangles(v0, v1, v2)
    if light_case is not None:
        name, spec = light_case
        scene, over, _ = light_scene(scene, name, SCENE_DIR / "small", dict(
            spec, n_tri=min(spec["n_tri"], 64),
            envmap=(64, 128) if spec["envmap"] else None))
        kw.update(over)
    cfg = small_config(width=64, height=64, num_rays=16_384, **kw)
    imgs = []
    for dev in ("cuda", "cpu"):
        ren = tr.Renderer(scene, cfg, device=dev)
        ren.step(camera_for_pose(0), 6)
        imgs.append(ren.image().cpu() if denoise_wave
                    else resolve(ren.state.accum.cpu(), cfg.width, cfg.height))
        if dev == "cuda":
            counts = ren.state.accum[:, 3].sum().item()
    mad = float((imgs[0] - imgs[1]).abs().mean())
    what = "denoised image() with wave" if denoise_wave else "resolve"
    if light_case is not None:
        what += f" of the lights path's {light_case[0]} scene"
    log(f"phase 4 card vs cpu at 64x64/16384 rays/6 steps, {what}: mean "
        f"|diff| {mad:.3g} ({counts:.0f} paths on the card)")
    if not mad < 0.03:
        raise AssertionError(f"card and CPU renders differ: {mad}")
    return mad


# where the loaded scene's asset instances stand: in pose 0's view, in
# front of and among the seven spheres (write_description gives them the
# GGX, glass and frosted looks in turn)
PLACEMENTS = ((-14.0, 12.0, 24.0), (14.0, 12.0, 24.0), (0.0, 4.0, 27.0),
              (-28.0, 28.0, 30.0), (28.0, 28.0, 30.0), (-8.0, 30.0, 40.0),
              (8.0, 30.0, 40.0), (0.0, 60.0, 45.0), (-40.0, 10.0, 20.0))


def loaded_path(cfg: RenderConfig, n_tris: int = 1_048_576,
                dispersion: float = 0.02) -> dict:
    """The loaded scene: ``benchmark_scene(n_tris)`` written as a binary
    PLY with vertex normals, the OBJ/MTL asset and a JSON description
    placing both (``scene.files``), loaded with ``load_description`` and
    rendered at ``cfg``'s size with the description's dispersion, pose 0
    under "mono" and "wave" (:func:`phase3`); then the kernels on its
    queues (:func:`kernels_at_slice`, without the stream kernel, which is
    not on a step)."""
    SCENE_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    ply = SCENE_DIR / "terrain.ply"
    counts = scene_files.write_ply(ply, *benchmark_scene(n_tris),
                                   normals=True)
    asset = scene_files.write_asset_obj(SCENE_DIR)
    desc = scene_files.write_description(SCENE_DIR / "scene.json", ply,
                                         asset, PLACEMENTS,
                                         dispersion=dispersion)
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    MeshAsset.load(str(ply))
    ply_s = time.perf_counter() - t0
    # the native loader (positions and faces) against the Python one
    t0 = time.perf_counter()
    v_n, f_n = ply_native.load_ply(str(ply))
    native_s = time.perf_counter() - t0
    v_p, f_p, _, _ = load_ply_attrs(str(ply))
    if not (np.array_equal(v_n.view(np.uint32), v_p.view(np.uint32))
            and np.array_equal(f_n, f_p)):
        raise AssertionError("the native PLY loader differs from the Python "
                             "loader")
    t0 = time.perf_counter()
    bundle = load_description(desc, builder="native")
    load_s = time.perf_counter() - t0
    sc = bundle.scene
    t0 = time.perf_counter()  # the BVH alone, rebuilt once to time it
    Scene.from_triangles(sc.tri_vert, sc.tri_vert + sc.tri_e1,
                         sc.tri_vert + sc.tri_e2, builder="native")
    bvh_s = time.perf_counter() - t0
    cfg = dataclasses.replace(cfg, **bundle.config)
    if cfg.dispersion != dispersion:
        raise AssertionError(f"the description's dispersion: {bundle.config}")
    torch.cuda.reset_peak_memory_stats()
    before_mb = torch.cuda.memory_allocated() / 1e6
    ren = tr.Renderer(sc, cfg)
    peak_mb = torch.cuda.max_memory_allocated() / 1e6
    sd = ren.scene
    flags = dict(has_ggx=sd.has_ggx, has_rrefr=sd.has_rrefr,
                 has_var_ior=sd.has_var_ior,
                 smooth_normals=sd.smooth_normals, spheres=sd.n_spheres)
    log(f"loaded scene: {counts['vertices']} vertices, {counts['faces']} "
        f"faces in the PLY; {sc.stats['triangles']} triangles, "
        f"{sc.stats['instances']} instances of {sc.stats['unique_meshes']} "
        f"meshes, {sd.bvh.n_nodes} nodes, {ren.tables.rows.shape[0]} fat "
        f"rows, max depth {ren.tables.max_depth}; files written in "
        f"{write_s:.2f} s; the PLY with normals parsed in {ply_s:.2f} s "
        f"(positions and faces by the native loader in {native_s:.2f} s, "
        f"equal to the Python loader's), the "
        f"description loaded (every file parsed, instances flattened, BVH "
        f"built) in {load_s:.2f} s, the BVH alone built in {bvh_s:.2f} s; "
        f"tri_attr {sd.tri_attr.numel() * 4 / 1e6:.1f} MB; device memory "
        f"after building the Renderer: peak {peak_mb:.1f} MB ({before_mb:.1f}"
        f" MB before); {flags}; dispersion {cfg.dispersion}")
    if not all(flags[k] for k in ("has_ggx", "has_rrefr", "has_var_ior",
                                  "smooth_normals")) or flags["spheres"] != 7:
        raise AssertionError(f"the loaded scene lacks a feature: {flags}")
    mono, launches_m = phase3(ren, (0,), "loaded-")
    ren_w = tr.Renderer(sd, dataclasses.replace(cfg, packet_kernel_mode="wave"),
                        tables=ren.tables)
    wave, launches_w = phase3(ren_w, (0,), "loaded-")
    del ren_w
    queues = kernels_at_slice(ren, stream=False, label="loaded")
    return dict(triangles=sc.stats["triangles"],
                instances=sc.stats["instances"], write_s=write_s,
                ply_parse_s=ply_s, native_ply_s=native_s, load_s=load_s,
                bvh_s=bvh_s,
                renderer_peak_mb=peak_mb, memory_before_mb=before_mb,
                flags=flags, poses=mono, poses_wave=wave,
                launches={"mono": launches_m, "wave": launches_w},
                queues=queues)


def sphere_free_path(cfg: RenderConfig, n_tris: int = 262_144) -> dict:
    """The sphere-free scene: ``benchmark_scene(n_tris)`` written as a
    double-sided glTF binary (every triangle and its flipped twin) and
    loaded with ``Scene.load``: no sphere, the sun alone.  Rendered at
    pose 0 under ``cfg`` (:func:`phase3`), then no hit may carry a sphere
    id, and the kernels on its queues, every extend ray seeded with
    VERY_FAR (:func:`kernels_at_slice`)."""
    SCENE_DIR.mkdir(parents=True, exist_ok=True)
    glb = scene_files.write_glb(SCENE_DIR / "bare.glb",
                                *benchmark_scene(n_tris))
    t0 = time.perf_counter()
    sc = Scene.load(glb, builder="native")
    load_s = time.perf_counter() - t0
    if sc.spheres.count:
        raise AssertionError("the glTF scene has spheres")
    ren = tr.Renderer(sc, cfg)
    log(f"sphere-free scene: {sc.stats['triangles']} triangles (double "
        f"sided), no sphere, loaded in {load_s:.2f} s; "
        f"{ren.tables.rows.shape[0]} fat rows, max depth "
        f"{ren.tables.max_depth}")
    poses, launches = phase3(ren, (0,), "sphere-free-")
    cam = camera_for_pose(0)
    rays = tr.merge_queue(cfg, ren.state, cam.to_device(cfg, DEV))
    t, ident, is_tri = tr._intersect_scene(rays["origin"], rays["direction"],
                                           ren.scene, ren.tables)
    hits = t < VERY_FAR
    n_sph = int((hits & ~is_tri).sum())
    log(f"sphere-free extend: {int(hits.sum())} of {t.shape[0]} rays hit, "
        f"{n_sph} with a sphere id, smallest id {int(ident.min())}")
    if n_sph or int(ident.min()) < -1:
        raise AssertionError("a hit without a triangle in a scene without "
                             "spheres")
    queues = kernels_at_slice(ren, stream=False, label="sphere-free")
    if not queues["extend"]["t_init_all_far"]:
        raise AssertionError("the sphere-free extend queue was seeded with "
                             "a sphere distance")
    return dict(triangles=sc.stats["triangles"], load_s=load_s, poses=poses,
                launches=launches, queues=queues)


# the lights path's two configurations: LIGHT triangles taken with a stride
# through the terrain's triangle list, the envmap's (height, width), and
# the render settings (ROADMAP Queue 1 item 5; PERF.md section 4)
LIGHT_CASES = {
    "many": dict(n_tri=4096, envmap=(1024, 2048),
                 render={"mis": True, "light_sampling": "power"}),
    "few": dict(n_tri=32, envmap=None,
                render={"mis": False, "light_sampling": "power"}),
}


def light_scene(scene_host, case: str, folder: Path, spec: dict):
    """The lights path's scene ``case`` on ``scene_host``'s mesh (its BVH
    reused): a JSON description and, with ``spec["envmap"]``, a procedural
    HDR sky as a PFM, written by ``scene.files`` into ``folder`` and
    loaded with ``load_description`` (the seven spheres with three of them
    emissive, a point, a spot and a directional light, the sky, the render
    settings); then ``spec["n_tri"]`` of the mesh's triangles made LIGHT
    (``scene.files.lamp_triangles``).  ``spec`` is a LIGHT_CASES entry or
    one cut to a smaller size.  Returns (Scene, config overrides, seconds
    to write and load the files)."""
    envmap = spec["envmap"]
    folder.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    env = None
    if envmap:
        env = scene_files.write_envmap_pfm(folder / f"sky_{case}.pfm",
                                           *envmap)
    desc = scene_files.write_lights_description(
        folder / f"lights_{case}.json", envmap=env, render=spec["render"])
    bundle = load_description(desc)
    refl, color = scene_files.lamp_triangles(scene_host.tri_vert.shape[0],
                                             spec["n_tri"])
    sc = dataclasses.replace(
        scene_host, spheres=bundle.scene.spheres,
        envmap=bundle.scene.envmap, delta_lights=bundle.scene.delta_lights,
        tri_refl=refl, tri_color=color)
    return sc, bundle.config, time.perf_counter() - t0


def lights_path(scene_host, cfg: RenderConfig,
                cases: dict = LIGHT_CASES) -> dict:
    """The lights path (``cases``, :data:`LIGHT_CASES` on the main scene)
    at ``cfg``'s size: for each configuration the Renderer's memory, phase
    3 eager
    (mono, 3 poses, the stage split) and captured (the captured state bit
    for bit the eager one after 6 steps with a pose and a sun change
    between, then 3 poses replayed), phase 3 with the wave kernel at pose
    0, both traversal kernels against the plain walk on its extend,
    shadow and AOV queues (the shadow queue's finite, shrunk ranges
    toward BVH emitters are the new traffic) and the accumulation on a
    step's queue, and a 64x64 render on the card against the CPU."""
    out = {}
    for case, spec in cases.items():
        sc, over, files_s = light_scene(scene_host, case, SCENE_DIR, spec)
        cfg_c = dataclasses.replace(cfg, fuse_step_chains="off", **over)
        t0 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        before_mb = torch.cuda.memory_allocated() / 1e6
        ren = tr.Renderer(sc, cfg_c)
        torch.cuda.synchronize()
        upload_s = time.perf_counter() - t0
        peak_mb = torch.cuda.max_memory_allocated() / 1e6
        sd = ren.scene
        multi, total = tr._n_lights(sd)
        counts = dict(sphere_lights=len(sd.light_indices),
                      tri_lights=sd.n_tri_lights,
                      delta_lights=sd.n_delta_lights, total=total,
                      envmap=[int(v) for v in sd.env_meta],
                      pick=("alias" if total > 64 else "cdf")
                      if tr._light_power_mode(cfg_c, sd, total)
                      else "uniform", mis=cfg_c.mis)
        log(f"lights {case}: {counts}; files written and loaded in "
            f"{files_s:.2f} s, scene packed and uploaded in {upload_s:.2f} "
            f"s; light tables {light_table_mb(sd):.1f} MB; device memory "
            f"after building the Renderer: peak {peak_mb:.1f} MB "
            f"({before_mb:.1f} MB before)")
        if not multi or sd.n_tri_lights != spec["n_tri"] \
                or len(sd.light_indices) != 3 or sd.n_delta_lights != 3 \
                or sd.has_envmap != bool(spec["envmap"]):
            raise AssertionError(f"the lights scene {case} lacks a light: "
                                 f"{counts}")
        poses, launches = phase3(ren, (0, 1, 2), f"lights-{case}-")
        cap = captured_step(sd, ren.tables, dataclasses.replace(
            cfg_c, fuse_step_chains="auto"), chain=False,
            label=f"lights-{case}-")
        compare_captured(poses, cap["poses"])
        ren_w = tr.Renderer(sd, dataclasses.replace(
            cfg_c, packet_kernel_mode="wave"), tables=ren.tables)
        poses_w, launches_w = phase3(ren_w, (0,), f"lights-{case}-")
        del ren_w
        queues = kernels_at_slice(ren, stream=False, label=f"lights-{case}")
        mad = phase4(light_case=(case, spec))
        runs = dict(eager=launches, captured=cap["launches"], wave=launches_w)
        if not (launches["traverse"] > 0 and launches["accumulate"] > 0
                and cap["launches"]["traverse"] > 0
                and launches_w["traverse_wave"] > 0):
            raise AssertionError(f"the lights path {case} did not run "
                                 f"through the kernels: {runs}")
        out[case] = dict(counts=counts, files_s=files_s, upload_s=upload_s,
                         renderer_peak_mb=peak_mb, memory_before_mb=before_mb,
                         poses=poses, poses_captured=cap["poses"],
                         poses_wave=poses_w, launches=runs, queues=queues,
                         card_vs_cpu=mad)
        del ren, cap, sd
        torch.cuda.empty_cache()
    return out


def stage_kernels(trace_path: Path, steps: int, stage: str = "shade",
                  top: int = 6) -> dict:
    """The device work of one stage of an eager step, from a phase-3
    trace, kernel by kernel (matched by correlation id as in
    :func:`stage_split`): ms and ops a step, the row gathers among them
    (PyTorch's gather and index-select kernels) counted and timed, and
    the ``top`` kernels by time."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    dev = {e["args"]["correlation"]: (e["name"], e["dur"]) for e in events
           if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")}
    spans = [(e["ts"], e["ts"] + e["dur"]) for e in events
             if e.get("cat") == "user_annotation" and e["name"] == stage]
    by_name: dict = {}
    for e in events:
        if e.get("cat") not in ("cuda_runtime", "cuda_driver"):
            continue
        rec = dev.get(e.get("args", {}).get("correlation"))
        if rec is None or not any(a <= e["ts"] <= b for a, b in spans):
            continue
        n, us = by_name.get(rec[0], (0, 0.0))
        by_name[rec[0]] = (n + 1, us + rec[1])
    gathers = {k: v for k, v in by_name.items()
               if "gather" in k or "ndexSelect" in k or "index_elementwise"
               in k}
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top]
    return dict(ms=sum(us for _, us in by_name.values()) / 1e3 / steps,
                ops=sum(n for n, _ in by_name.values()) / steps,
                gathers=sum(n for n, _ in gathers.values()) / steps,
                gather_ms=sum(us for _, us in gathers.values()) / 1e3
                / steps,
                gather_kernels=sorted(gathers),
                top=[(k[:60], n / steps, us / 1e3 / steps)
                     for k, (n, us) in ranked])


def log_stage(label: str, sk: dict) -> None:
    log(f"{label} shade: {sk['ms']:.3f} ms and {sk['ops']:g} device ops a "
        f"step, {sk['gathers']:g} row gathers a step taking "
        f"{sk['gather_ms']:.3f} ms ({', '.join(sk['gather_kernels'])}); "
        "top kernels (name, a step, ms): "
        + "; ".join(f"{k} {n:g} {ms:.3f}" for k, n, ms in sk["top"]))


def card_vs_cpu(scene, cfg: RenderConfig, what: str,
                steps: int = 6) -> float:
    """A 32x32 render of ``scene`` under ``cfg`` (16,384 rays, pose 0) on
    the card against the same render on the CPU: the mean absolute
    difference of the resolved images, which must stay under 0.03."""
    cfg = dataclasses.replace(cfg, width=32, height=32, num_rays=16_384,
                              fuse_step_chains="off")
    imgs = []
    for dev in ("cuda", "cpu"):
        ren = tr.Renderer(scene, cfg, device=dev)
        ren.step(camera_for_pose(0), steps)
        imgs.append(resolve(ren.state.accum.cpu(), 32, 32))
        if dev == "cuda":
            counts = ren.state.accum[:, 3].sum().item()
    mad = float((imgs[0] - imgs[1]).abs().mean())
    log(f"{what} card vs cpu at 32x32/16384 rays/{steps} steps: mean "
        f"|diff| {mad:.3g} ({counts:.0f} paths on the card)")
    if not mad < 0.03:
        raise AssertionError(f"{what}: card and CPU renders differ: {mad}")
    return mad


def queue_checks(label: str, queues: dict) -> None:
    """The traversal kernels agree with the plain walk on a path's extend,
    shadow and AOV queues, and the accumulation with its plain version."""
    bad = [(q, gen) for q in ("extend", "connect", "aov")
           for gen in ("mono", "wave") if queues[q][gen]["mismatches"]]
    if bad or queues["accumulate"]["max_abs_err"] != 0.0:
        raise AssertionError(f"{label}: mismatches on {bad}")


def path_checks(label: str, launches: dict, cap: dict, wave: dict,
                queues: dict) -> None:
    """A path's kernels ran on it and agree with their plain versions."""
    queue_checks(label, queues)
    if not (launches["traverse"] > 0 and launches["accumulate"] > 0
            and cap["launches"]["traverse"] > 0
            and wave["traverse_wave"] > 0):
        raise AssertionError(f"the {label} path did not run through the "
                             f"kernels: {launches}, {cap['launches']}, "
                             f"{wave}")


def textures_path(cfg: RenderConfig, n_tris: int = 1_048_576,
                  n_leaves: int = 65_536, n_blend: int = 1_024,
                  poses_run=(0, 1, 2), texture_px=None,
                  small: dict | None = None) -> dict:
    """The textured scene (``scene.files.textured_scene`` on
    ``benchmark_scene(n_tris)``, in memory: albedo, normal and
    roughness/metal maps, ``n_leaves`` cutout leaves and ``n_blend``
    blend triangles, clamp and mirrored wraps) under the seven spheres at
    ``cfg``'s size: the host's seconds (maps, BVH, the atlas with mips,
    the whole upload with the tangents) and the Renderer's memory; phase
    3 eager and captured (bit for bit the eager step first) under
    "bilinear" at ``poses_run``, eager at pose 0 under "nearest",
    "trilinear" and with the wave kernel, shade's split with its row
    gathers; the textured shade kernels on the bilinear and the nearest
    Renderer's queue (:func:`shade_at_step`); ``image()`` with the
    denoiser; the kernels on its queues and its step's accumulation; a
    32x32 render on the card against the CPU (``small`` sizes its
    scene)."""
    texture_px = texture_px or {}
    t0 = time.perf_counter()
    mesh = benchmark_scene(n_tris)
    kw = scene_files.textured_scene(*mesh, n_leaves=n_leaves,
                                    n_blend=n_blend, **texture_px)
    maps_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    sc = Scene.from_triangles(builder="auto", **kw)
    bvh_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    TextureAtlas.pack(kw["textures"], mips=True)
    atlas_s = time.perf_counter() - t0
    cfg_e = dataclasses.replace(cfg, fuse_step_chains="off",
                                texture_filter="bilinear")
    torch.cuda.reset_peak_memory_stats()
    before_mb = torch.cuda.memory_allocated() / 1e6
    t0 = time.perf_counter()
    ren = tr.Renderer(sc, cfg_e)
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t0
    peak_mb = torch.cuda.max_memory_allocated() / 1e6
    sd = ren.scene
    t0 = time.perf_counter()  # the attribute rows alone: uvs, tangents
    sc._attr_rows(sd.tri_attr.shape[0], True, True, True, False)
    attr_s = time.perf_counter() - t0
    flags = {k: getattr(sd, k) for k in (
        "has_albedo_tex", "has_normal_maps", "has_rough_maps",
        "has_alpha_tex", "has_blend", "has_metal_maps", "has_ggx")}
    atlas_mb = sd.tex_data.numel() * 4 / 1e6
    attr_mb = sd.tri_attr.numel() * 4 / 1e6
    log(f"textures: {sc.stats['triangles']} triangles ({n_leaves} leaves, "
        f"{n_blend} blend), {len(sd.tex_meta)} maps "
        f"{[m[1:5] for m in sd.tex_meta]} with {len(sd.tex_meta[0][5])} "
        f"levels on the first; {ren.tables.rows.shape[0]} fat rows, max "
        f"depth {ren.tables.max_depth}; maps made in {maps_s:.2f} s, BVH "
        f"built in {bvh_s:.2f} s, the atlas with mips packed in "
        f"{atlas_s:.2f} s alone, the attribute rows with it and the "
        f"tangents {attr_s:.2f} s alone, the upload (atlas, mips, tangents, "
        f"tables) {upload_s:.2f} s; atlas {atlas_mb:.1f} MB, tri_attr "
        f"{attr_mb:.1f} MB; device memory after building the Renderer: peak "
        f"{peak_mb:.1f} MB ({before_mb:.1f} MB before); {flags}")
    if not all(flags.values()):
        raise AssertionError(f"the textured scene lacks a map: {flags}")
    poses, launches = phase3(ren, poses_run, "tex-")
    split = {"bilinear": stage_kernels(
        TRACE_DIR / "trace_tex-mono_pose0.json", 2)}
    log_stage("textures bilinear", split["bilinear"])
    cap = captured_step(sd, ren.tables, dataclasses.replace(
        cfg_e, fuse_step_chains="auto"), poses_run, chain=False,
        label="tex-")
    compare_captured(poses, cap["poses"])
    filters, at_step = {}, {}
    for filt in ("nearest", "trilinear"):
        ren_f = tr.Renderer(sd, dataclasses.replace(cfg_e,
                                                    texture_filter=filt),
                            tables=ren.tables)
        filters[filt], _ = phase3(ren_f, (0,), f"tex-{filt}-")
        split[filt] = stage_kernels(
            TRACE_DIR / f"trace_tex-{filt}-mono_pose0.json", 2)
        log_stage(f"textures {filt}", split[filt])
        if filt == "nearest":
            at_step[filt] = shade_at_step(ren_f)
        del ren_f
    ren_w = tr.Renderer(sd, dataclasses.replace(cfg_e,
                                                packet_kernel_mode="wave"),
                        tables=ren.tables)
    poses_w, launches_w = phase3(ren_w, (0,), "tex-")
    del ren_w
    at_step["bilinear"] = shade_at_step(ren)
    ren_d = tr.Renderer(sd, dataclasses.replace(cfg_e, denoise="on"),
                        tables=ren.tables)
    ren_d.step(camera_for_pose(0), 8)
    img, image_ms = timed_once(ren_d.image)
    if not (bool(torch.isfinite(img).all()) and float(img.max()) > 0):
        raise AssertionError("the textured image() is not finite")
    log(f"textures image() with the denoiser after 8 steps: {image_ms:.3f} "
        "ms (the AOV pass samples the albedo and normal maps)")
    del ren_d
    queues = kernels_at_slice(ren, stream=False, label="textures")
    path_checks("textures", launches, cap, launches_w, queues)
    small = small or {}
    mad = card_vs_cpu(Scene.from_triangles(**scene_files.textured_scene(
        *terrain(n_quads=small.get("n_quads", 48), towers=4),
        n_leaves=small.get("n_leaves", 2048),
        n_blend=small.get("n_blend", 256), albedo_px=64, normal_px=64,
        rough_px=32, leaf_px=32)), cfg_e, "textures")
    return dict(triangles=sc.stats["triangles"], maps_s=maps_s, bvh_s=bvh_s,
                atlas_s=atlas_s, attr_s=attr_s, upload_s=upload_s,
                atlas_mb=atlas_mb,
                tri_attr_mb=attr_mb, renderer_peak_mb=peak_mb,
                memory_before_mb=before_mb, flags=flags, poses=poses,
                poses_captured=cap["poses"], filters=filters,
                poses_wave=poses_w, shade=split, at_step=at_step,
                image_ms=image_ms,
                launches=dict(eager=launches, captured=cap["launches"],
                              wave=launches_w),
                queues=queues, card_vs_cpu=mad)


# the fog path's medium (ROADMAP Queue 1 item 8; PERF.md section 4): the
# slab spans the mesh's z range
FOG = dict(fog="on", fog_sigma_s=0.02, fog_sigma_a=0.005, fog_g=0.6,
           fog_falloff=0.05)


def fog_path(scene_host, cfg: RenderConfig, poses_run=(0, 1, 2),
             light_spec=None) -> dict:
    """Height fog on the main scene (``scene_host``, its BVH reused) at
    ``cfg``'s size, the slab over the mesh's z range (:data:`FOG`): the
    Renderer's memory; phase 3 eager and captured (bit for bit the eager
    step first) at ``poses_run`` and with the wave kernel at pose 0,
    shade's split; the kernels on its queues and its step's
    accumulation; then once eager at pose 0 with the lights "few"
    configuration of :data:`LIGHT_CASES` (or ``light_spec``) and
    ``mis="on"``, which runs fog's triangle- and delta-light lanes; a
    32x32 render on the card against the CPU."""
    corners = np.concatenate([scene_host.tri_vert,
                              scene_host.tri_vert + scene_host.tri_e1,
                              scene_host.tri_vert + scene_host.tri_e2])
    fog = dict(FOG, fog_z_min=float(corners[:, 2].min()),
               fog_z_max=float(corners[:, 2].max()))
    cfg_f = dataclasses.replace(cfg, fuse_step_chains="off", **fog)
    torch.cuda.reset_peak_memory_stats()
    before_mb = torch.cuda.memory_allocated() / 1e6
    t0 = time.perf_counter()
    ren = tr.Renderer(scene_host, cfg_f)
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t0
    peak_mb = torch.cuda.max_memory_allocated() / 1e6
    sd = ren.scene
    log(f"fog: {fog}; the scene uploaded in {upload_s:.2f} s; device "
        f"memory after building the Renderer: peak {peak_mb:.1f} MB "
        f"({before_mb:.1f} MB before)")
    poses, launches = phase3(ren, poses_run, "fog-")
    split = {"fog": stage_kernels(TRACE_DIR / "trace_fog-mono_pose0.json",
                                  2)}
    log_stage("fog", split["fog"])
    cap = captured_step(sd, ren.tables, dataclasses.replace(
        cfg_f, fuse_step_chains="auto"), poses_run, chain=False,
        label="fog-")
    compare_captured(poses, cap["poses"])
    ren_w = tr.Renderer(sd, dataclasses.replace(cfg_f,
                                                packet_kernel_mode="wave"),
                        tables=ren.tables)
    poses_w, launches_w = phase3(ren_w, (0,), "fog-")
    del ren_w
    queues = kernels_at_slice(ren, stream=False, label="fog")
    path_checks("fog", launches, cap, launches_w, queues)
    spec = light_spec or LIGHT_CASES["few"]
    sc_l, over, _ = light_scene(scene_host, "few", SCENE_DIR, spec)
    cfg_l = dataclasses.replace(cfg_f, **dict(over, mis="on"))
    ren_l = tr.Renderer(sc_l, cfg_l)
    if not (ren_l.scene.n_tri_lights and ren_l.scene.n_delta_lights):
        raise AssertionError("the fog lights scene lacks its lights")
    poses_l, launches_l = phase3(ren_l, (0,), "fog-lights-")
    split["lights"] = stage_kernels(
        TRACE_DIR / "trace_fog-lights-mono_pose0.json", 2)
    log_stage("fog with the lights few, mis on", split["lights"])
    del ren_l
    lamps = fog_lamps_captured(scene_host, cfg_f, poses_run)
    v0, v1, v2 = terrain(n_quads=48, towers=4)
    small = Scene.from_triangles(v0, v1, v2)
    zs = np.concatenate([v0, v1, v2])[:, 2]
    mad = card_vs_cpu(small, dataclasses.replace(
        cfg_f, fog_z_min=float(zs.min()), fog_z_max=float(zs.max())), "fog")
    return dict(fog=fog, upload_s=upload_s, renderer_peak_mb=peak_mb,
                memory_before_mb=before_mb, poses=poses,
                poses_captured=cap["poses"], poses_wave=poses_w,
                poses_lights=poses_l, shade=split,
                launches=dict(eager=launches, captured=cap["launches"],
                              wave=launches_w, lights=launches_l),
                queues=queues, card_vs_cpu=mad, lamps=lamps)


# the fog_lights_1m configuration's lights: the lamps of "many" without its
# envmap and MIS
FOG_LAMPS = dict(n_tri=4096, envmap=None,
                 render={"mis": False, "light_sampling": "power"})


def fog_lamps_captured(scene_host, cfg_f: RenderConfig, poses_run=(0, 1, 2),
                       steps: int = 3) -> dict:
    """The ``fog_lights_1m`` combination on the main scene under the fog
    of ``cfg_f``: :data:`FOG_LAMPS` (4,096 lamp triangles, three emissive
    spheres, a point, a spot and a directional light: 4,102 lights, an
    alias pick, no MIS).  An eager and a captured Renderer step ``steps``
    times at each pose of ``poses_run`` in turn, and after each pose every
    RenderState field must be equal bit for bit; then phase 3 on the
    captured renderer at those poses."""
    sc, over, _ = light_scene(scene_host, "fog-lamps", SCENE_DIR, FOG_LAMPS)
    cfg_l = dataclasses.replace(cfg_f, **over)
    eager = tr.Renderer(sc, dataclasses.replace(cfg_l,
                                                fuse_step_chains="off"))
    sd = eager.scene
    _, total = tr._n_lights(sd)
    if not (total > 64 and tr._light_power_mode(cfg_l, sd, total)
            and cfg_l.mis == "off" and not sd.has_envmap
            and tr._fog_on(cfg_l)):
        raise AssertionError(f"the fog lamps scene is not fog_lights_1m's "
                             f"combination: {total} lights, light_sampling "
                             f"{cfg_l.light_sampling}, mis {cfg_l.mis}")
    cap = tr.Renderer(sd, dataclasses.replace(cfg_l,
                                              fuse_step_chains="auto"),
                      tables=eager.tables)
    if eager.captured or not cap.captured:
        raise AssertionError("fuse_step_chains did not select the step")
    for i in poses_run:
        for ren in (eager, cap):
            ren.step(camera_for_pose(i), steps)
        torch.cuda.synchronize()
        if not states_equal(eager.state, cap.state):
            bad = [k for k in STATE_FIELDS if not torch.equal(
                getattr(eager.state, k), getattr(cap.state, k))]
            raise AssertionError(f"fog lamps: captured and eager states "
                                 f"differ at pose {i} in: {bad}")
    log(f"fog lamps ({total} lights, alias pick, no MIS): captured bit for "
        f"bit the eager step after {steps} steps at each of poses "
        f"{list(poses_run)}; {cap.replayed_steps} replayed")
    del eager
    poses, launches = phase3(cap, poses_run, "fog-lamps-")
    del cap
    torch.cuda.empty_cache()
    return dict(lights=total, equal_at_poses=list(poses_run), poses=poses,
                launches=launches)


# the camera modes of the sampling path, each eager at pose 0 (the crop: the
# 960x540 centre of the 1920x1080 frame)
CAMERA_MODES = {
    "fisheye": dict(projection="fisheye", fisheye_fov_degrees=180.0),
    "equirect": dict(projection="equirect"),
    "ortho-bokeh": dict(projection="ortho", ortho_height=120.0,
                        bokeh_blades=6, bokeh_rotation=15.0),
    "crop-clamp": dict(crop=(480, 270, 960, 540), radiance_clamp=10.0),
}


def lens_camera(i: int):
    """Pose i with a lens of radius 1 focused at 30 units: the polygonal
    aperture shows only through a lens."""
    cam = camera_for_pose(i)
    cam.lens_radius, cam.focal_distance = 1.0, 30.0
    return cam


def sample_base_check(scene, tables, cfg: RenderConfig,
                      steps: int = 6) -> dict:
    """Sobol's pass counter after ``steps`` eager steps at pose 0: the
    fresh rays generated (read from ``n_carried`` before each step) must
    be sample_base * (pixels a pass) + start_position, and no carried
    ray's sample index may pass sample_base + 1."""
    ren = tr.Renderer(scene, dataclasses.replace(cfg, fuse_step_chains="off"),
                      tables=tables)
    generated = 0
    for _ in range(steps):
        generated += cfg.num_rays - int(ren.state.n_carried)
        ren.step(camera_for_pose(0), 1)
    st = ren.state
    total = tr._scan_total(cfg)
    counted = int(st.sample_base) * total + int(st.start_position)
    top = int(st.sample_idx.max())
    log(f"sobol bookkeeping after {steps} steps: {generated} fresh rays, "
        f"sample_base {int(st.sample_base)} x {total} + start_position "
        f"{int(st.start_position)} = {counted}; largest sample index {top}")
    if counted != generated or top > int(st.sample_base) + 1:
        raise AssertionError("Sobol's sample_base does not count the "
                             "round-robin passes")
    return dict(steps=steps, generated=generated,
                sample_base=int(st.sample_base),
                start_position=int(st.start_position), max_sample_idx=top)


def moment2_at_step(ren, reps: int = 20) -> dict:
    """The fused moment2 mode of ``accumulate_terminated`` on the queue of
    the step just run (adaptive sampling or track_variance): accum and
    moment2 bit for bit the plain version (two ``accumulate_plain``
    calls) on the CPU; timed with the L2 evicted before each call against
    the plain version and the library's two ``index_add_`` calls; the
    kernel alone back to back as a side note."""
    key, pend = step_queue(ren)
    p = ren.cfg.num_pixels
    n = key.shape[0]
    acc0, m0 = ren.state.accum.clone(), ren.state.moment2.clone()
    kc, pc = key.cpu(), pend.cpu()
    want_a = kacc.accumulate_plain(acc0.cpu().clone(),
                                   *kacc.terminated_updates(kc, pc, p))
    want_m = kacc.accumulate_plain(m0.cpu().clone(),
                                   *kacc.moment2_updates(kc, pc, p))
    got_m = m0.clone()
    got_a = kacc.accumulate_terminated(acc0.clone(), key, pend,
                                       moment2=got_m).cpu()
    if not (same_bits(got_a, want_a) and same_bits(got_m.cpu(), want_m)):
        raise AssertionError("the moment2 mode differs from its plain "
                             "version on the step's queue")
    acc, m2 = acc0.clone(), m0.clone()

    def fused():
        return kacc.accumulate_terminated(acc, key, pend, moment2=m2)

    def plain():
        kacc.accumulate_plain(m2, *kacc.moment2_updates(key, pend, p))
        return kacc.accumulate_plain(acc, *kacc.terminated_updates(key,
                                                                   pend, p))

    live, distinct = live_entries(key, p)
    (pix, vals), (_, sq) = kacc.terminated_updates(key, pend, p), \
        kacc.moment2_updates(key, pend, p)
    pix_l, vals_l, sq_l = pix[:live], vals[:live], sq[:live]
    lib_a, lib_m = acc0.clone(), m0.clone()

    def library():
        lib_a.index_add_(0, pix_l, vals_l)
        return lib_m.index_add_(0, pix_l, sq_l)

    out = dict(rays=n, max_abs_err=0.0, live=live, distinct=distinct,
               ms=cuda_ms(fused, reps, cold=True),
               kernel_ms_warm_l2=kernel_ms(fused, ACCUM_KERNELS),
               plain_ms=cuda_ms(plain, reps, cold=True),
               library_ms=cuda_ms(library, reps, cold=True))
    out["bound_ms"], out["bound_by"] = accum_bound(n, live, distinct, 12,
                                                   buffers=2)
    log(f"step accumulate, moment2 mode: {live} of {n} entries below P on "
        f"{distinct} pixels; accum and moment2 bit for bit the plain "
        f"version; with the L2 evicted: fused {out['ms']:.4f} ms, plain "
        f"(two accumulate_plain) {out['plain_ms']:.4f} ms, two index_add_ "
        f"{out['library_ms']:.4f} ms; bound {out['bound_ms']:.4f} ms "
        f"({out['bound_by']}); back to back, the buffers in the L2: kernel "
        f"alone {fmt_ms(out['kernel_ms_warm_l2'])}")
    return out


def adaptive_run(scene, tables, cfg: RenderConfig, chunks: int = 4) -> dict:
    """Adaptive sampling with ``track_variance``, captured, at pose 0:
    ``chunks`` calls of ``adaptive_interval`` steps, one perm rebuild
    after each, timed with CUDA events (the rebuilds inside); each perm
    monotone and in range, the noise estimate falling from the second
    chunk on, the steps replayed
    and their accumulation the moment2 mode's launch; ``build_perm``
    alone at full size."""
    ren = tr.Renderer(scene, cfg, tables=tables)
    reset_launches(ren)
    cam = camera_for_pose(0)
    k = cfg.adaptive_interval
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    ren.step(cam, 1)  # the capture's warm-up and the capture, untimed
    perms, noise = [], []
    a.record()
    for i in range(chunks):
        ren.step(cam, k - 1 if i == 0 else k)
        perms.append(ren.state.pixel_perm.clone())
        noise.append(adaptive_mod.mean_relative_error(ren.state.accum,
                                                      ren.state.moment2))
    b.record()
    torch.cuda.synchronize()
    steps = chunks * k
    ms = a.elapsed_time(b) / (steps - 1)
    p = cfg.num_pixels
    noise = [float(x) for x in noise]
    for perm in perms:
        d = perm[1:] - perm[:-1]
        if not (bool((d >= 0).all()) and int(perm.min()) >= 0
                and int(perm.max()) < p):
            raise AssertionError("an adaptive perm is not monotone in range")
    if (torch.equal(perms[-1], adaptive_mod.identity_perm(p, DEV))
            or ren._sched.rebuilds != chunks):
        raise AssertionError(f"{ren._sched.rebuilds} perm rebuilds, "
                             f"expected {chunks}")
    # after the first chunk most pixels hold fewer than two paths and are
    # left out of the estimate's mean: it falls from the second on
    if not all(b < a for a, b in zip(noise[1:], noise[2:])):
        raise AssertionError(f"the noise estimate did not fall: {noise}")
    if ren.noise_estimate() != noise[-1]:
        raise AssertionError("Renderer.noise_estimate() is not the mean "
                             "relative error of its moments")
    launches = read_launches(ren, keys=LAUNCH_KEYS + MOMENT2_KEYS)
    check_replays(ren, steps)
    if (launches["accumulate_moment2"] != steps or launches["accumulate"]
            or launches["traverse"] != 2 * steps):
        raise AssertionError(f"adaptive launches {launches} over {steps} "
                             "steps")
    phase = torch.tensor(0.5, device=DEV)
    perm_ms = cuda_ms(lambda: adaptive_mod.build_perm(
        ren.state.accum, ren.state.moment2, phase, cfg.adaptive_gamma), 5)
    counts = torch.bincount(perms[-1].long(), minlength=p)
    log(f"adaptive (interval {k}, track_variance, captured): {steps} steps "
        f"{ms:.3f} ms/step with {chunks} rebuilds, build_perm alone "
        f"{perm_ms:.3f} ms; noise estimate by rebuild "
        f"{', '.join(f'{x:.5f}' for x in noise)}; the last perm visits "
        f"{int((counts > 0).sum())} of {p} pixels, at most "
        f"{int(counts.max())} times; launches {launches} "
        f"({ren.replayed_steps} steps replayed)")
    return dict(ren=ren, steps=steps, ms_per_step=ms, build_perm_ms=perm_ms,
                noise=noise, rebuilds=ren._sched.rebuilds,
                pixels_visited=int((counts > 0).sum()),
                max_visits=int(counts.max()), launches=launches)


def checkpoint_on_card(scene, tables, cfg: RenderConfig, first: int = 8,
                       then: int = 4) -> dict:
    """``first`` steps at pose 0, ``save_state`` to
    ``build/chip_smoke/checkpoint.npz``, ``load_state`` into a fresh
    Renderer, ``then`` steps: every RenderState field bit for bit the
    state of ``first + then`` uninterrupted steps (renderers as ``cfg``
    selects, captured by default)."""
    cam = camera_for_pose(0)
    whole = tr.Renderer(scene, cfg, tables=tables)
    whole.step(cam, first + then)
    ren = tr.Renderer(scene, cfg, tables=tables)
    ren.step(cam, first)
    TRACE_DIR.mkdir(parents=True, exist_ok=True)
    path = TRACE_DIR / "checkpoint.npz"
    t0 = time.perf_counter()
    checkpoint.save_state(str(path), ren.state, {"steps": first})
    save_s = time.perf_counter() - t0
    resumed = tr.Renderer(scene, cfg, tables=tables)
    t0 = time.perf_counter()
    resumed.state, meta = checkpoint.load_state(str(path))
    load_s = time.perf_counter() - t0
    resumed.step(cam, then)
    torch.cuda.synchronize()
    if meta != {"steps": first} or not states_equal(resumed.state,
                                                     whole.state):
        raise AssertionError("the resumed render differs from the "
                             "uninterrupted one")
    mb = path.stat().st_size / 1e6
    log(f"checkpoint on the card ({'captured' if whole.captured else 'eager'}"
        f", sampler {cfg.sampler}, track_variance {cfg.track_variance}): "
        f"{first} steps, save {save_s:.2f} s ({mb:.1f} MB .npz), load "
        f"{load_s:.2f} s, {then} steps: bit for bit the {first + then} "
        "uninterrupted steps")
    return dict(first=first, then=then, save_s=save_s, load_s=load_s,
                file_mb=mb, captured=whole.captured)


def blur_flythrough(scene, tables, cfg: RenderConfig,
                    n_frames: int = 20) -> dict:
    """The interactive fly-through (``bench/interactive.py``) under motion
    blur, captured and eager: ms a frame moving and still, the launches,
    replays counted, which must be the steps' (with kernel normals on the
    extend queue)."""
    out = {}
    for fuse in ("auto", "off"):
        c = dataclasses.replace(cfg, fuse_step_chains=fuse)
        reset_launches()
        res = interactive.run_interactive(scene, c, n_frames=n_frames,
                                          tables=tables)
        ren = res.pop("renderer")
        steps = 2 * (interactive.WARMUP_FRAMES + n_frames)
        launches = read_launches(ren, keys=LAUNCH_KEYS + NORMALS_KEYS)
        if launches["accumulate"] != steps \
                or launches["traverse"] != 2 * steps \
                or launches["traverse_normals"] != steps:
            raise AssertionError(f"blurred fly-through {fuse}: launches "
                                 f"{launches} over {steps} steps")
        if ren.captured:
            check_replays(ren, steps)
        out[fuse] = dict(res, launches=launches, steps=steps,
                         captured=ren.captured)
        log(f"fly-through with motion_blur={c.motion_blur} fuse={fuse}: "
            f"moving {res['moving']['mean_ms']:.3f} ms/frame (median "
            f"{res['moving']['median_ms']:.3f}, "
            f"{res['moving']['fps']:.1f} FPS), still "
            f"{res['still']['mean_ms']:.3f} ms/frame; launches {launches}")
        del ren
    return out


def sampling_path(scene_host, cfg: RenderConfig, poses_run=(0, 1, 2),
                  preset: RenderConfig | None = None, fly_frames: int = 20,
                  modes=None, small=None) -> dict:
    """The rest of RenderConfig on the main scene at ``cfg``'s size:
    Sobol with seed 7 (phase 3 eager and captured, the captured step bit
    for bit the eager one, wave at pose 0, shade's split, the pass
    counter, the kernels on its queues, a checkpoint's resume bit for
    bit, the card against the CPU);
    adaptive sampling with track_variance, captured (:func:`adaptive_run`,
    its step bit for bit the eager one, the fused moment2 mode on its
    step's queue); motion blur on the interactive preset (``preset``)
    with kernel normals, its captured step bit for bit the eager one
    through a pose change, and the fly-through captured and eager; and
    the camera modes of :data:`CAMERA_MODES` (or ``modes``), each eager
    at pose 0 with the kernels on its queues."""
    cfg_s = dataclasses.replace(cfg, fuse_step_chains="off", sampler="sobol",
                                seed=7)
    ren = tr.Renderer(scene_host, cfg_s)
    sd, tables = ren.scene, ren.tables
    out = dict(launches={}, queues={})
    # Sobol
    out["sobol"], launches = phase3(ren, poses_run, "sobol-")
    out["launches"]["sobol-eager"] = launches
    out["shade"] = {"sobol": stage_kernels(
        TRACE_DIR / "trace_sobol-mono_pose0.json", 2)}
    log_stage("sobol", out["shade"]["sobol"])
    ren_w = tr.Renderer(sd, dataclasses.replace(cfg_s,
                                                packet_kernel_mode="wave"),
                        tables=tables)
    out["sobol_wave"], out["launches"]["sobol-wave"] = phase3(
        ren_w, (0,), "sobol-")
    del ren_w
    cap = captured_step(sd, tables, dataclasses.replace(
        cfg_s, fuse_step_chains="auto"), poses_run, chain=False,
        label="sobol-")
    compare_captured(out["sobol"], cap["poses"])
    out["sobol_captured"] = cap["poses"]
    out["launches"]["sobol-captured"] = cap["launches"]
    out["queues"]["sobol"] = kernels_at_slice(ren, stream=False,
                                              label="sobol")
    queue_checks("sobol", out["queues"]["sobol"])
    del ren
    out["sobol_bookkeeping"] = sample_base_check(sd, tables, cfg_s)
    out["checkpoint"] = checkpoint_on_card(sd, tables, dataclasses.replace(
        cfg_s, fuse_step_chains="auto", track_variance="on"))
    v0, v1, v2 = terrain(n_quads=48, towers=4)
    out["card_vs_cpu"] = card_vs_cpu(small or Scene.from_triangles(v0, v1, v2),
                                     cfg_s, "sobol")
    # adaptive sampling with the second moments
    cfg_a = dataclasses.replace(cfg, adaptive_sampling="on",
                                adaptive_interval=4, track_variance="on")
    cap = captured_step(sd, tables, cfg_a, (0,), chain=False,
                        label="adaptive-")
    out["adaptive_captured"] = cap["poses"]
    out["launches"]["adaptive-captured"] = cap["launches"]
    ad = adaptive_run(sd, tables, cfg_a)
    ren = ad.pop("ren")
    out["adaptive"] = ad
    out["launches"]["adaptive"] = ad["launches"]
    out["moment2_step_queue"] = moment2_at_step(ren)
    out["queues"]["adaptive"] = kernels_at_slice(ren, stream=False,
                                                 label="adaptive")
    queue_checks("adaptive", out["queues"]["adaptive"])
    del ren
    # motion blur on the interactive preset, kernel normals on
    pre = dataclasses.replace(preset or interactive_config(), motion_blur=0.5,
                              use_kernel_normals="on")
    cap = captured_step(sd, tables, pre, (0,), chain=False, label="blur-")
    out["blur_captured"] = cap["poses"]
    out["launches"]["blur-captured"] = cap["launches"]
    out["blur_flythrough"] = blur_flythrough(sd, tables, pre, fly_frames)
    ren = tr.Renderer(sd, dataclasses.replace(pre, fuse_step_chains="off"),
                      tables=tables)
    ren.step(camera_for_pose(1), 1)  # pose 0's rays lerp from pose 1
    out["queues"]["blur"] = kernels_at_slice(ren, stream=False, label="blur")
    queue_checks("blur", out["queues"]["blur"])
    del ren
    # the camera modes, eager at pose 0
    out["modes"] = {}
    for name, kw in (modes or CAMERA_MODES).items():
        cam = lens_camera if name.endswith("bokeh") else camera_for_pose
        ren = tr.Renderer(sd, dataclasses.replace(
            cfg, fuse_step_chains="off", **kw), tables=tables)
        poses, launches = phase3(ren, (0,), f"{name}-", camera=cam)
        queues = kernels_at_slice(ren, stream=False, label=name,
                                  camera=cam)
        queue_checks(name, queues)
        out["modes"][name] = dict(config=kw, poses=poses)
        out["launches"][name] = launches
        out["queues"][name] = queues
        del ren
    return out


# --------------------------------------------------------------------------
# the front ends (cli, viewer, utils) and the strip-parallel path
# --------------------------------------------------------------------------

def pose_argv(i: int) -> list:
    """The CLI's ``--camera X Y Z H V`` of the benchmark's pose ``i``."""
    cam = camera_for_pose(i)
    return ["--camera", *(repr(float(v)) for v in cam.position),
            repr(float(cam.horizontal_angle)), repr(float(cam.vertical_angle))]


def run_cli(argv: list) -> tuple[str, str, float]:
    """(stdout, stderr, seconds) of ``cli.main(argv)``, launches counted
    from 0."""
    out, err = io.StringIO(), io.StringIO()
    reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        cli.main(argv)
    torch.cuda.synchronize()
    return out.getvalue(), err.getvalue(), time.perf_counter() - t0


def stage_profile_check(ren, split: dict, busy_ms: float) -> dict:
    """``utils.profiling.stage_profile`` on the main cell at pose 0 (an
    eager renderer): each stage's median against phase 3's device split
    of the same stage (``stage_split``), and the state left as it was."""
    cam = camera_for_pose(0)
    ren.step(cam, 4)
    torch.cuda.synchronize()
    before = {k: getattr(ren.state, k).clone() for k in STATE_FIELDS}
    prof = profiling.stage_profile(ren, cam, n_steps=5)
    torch.cuda.synchronize()
    if not all(torch.equal(getattr(ren.state, k), v)
               for k, v in before.items()):
        raise AssertionError("stage_profile advanced the renderer's state")
    if not all(np.isfinite(v) and v > 0 for v in prof.values()):
        raise AssertionError(f"stage_profile: {prof}")
    log("stage_profile pose 0 (medians of 5, CUDA events) against phase "
        "3's device split: " + ", ".join(
            f"{k} {prof[k + '_ms']:.3f}/{split[k]:.3f}"
            for k in ("raygen", "extend", "shade", "connect"))
        + f"; full step {prof['full_step_ms']:.3f} ms against "
        f"{busy_ms:.3f} ms busy; stage sum {prof['stage_sum_ms']:.3f} ms")
    return dict(prof, split_ms={k: split[k] for k in STAGES},
                split_busy_ms=busy_ms)


def png_pixels(data: bytes) -> np.ndarray:
    """Decode what ``viewer._to_png_bytes`` writes (8-bit RGB, filter 0 on
    every row) to [H, W, 3] uint8, with zlib (the card's machine has no
    Pillow); raises on any other PNG."""
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError("not a PNG")
    pos, idat, hdr = 8, [], None
    while pos < len(data):
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if tag == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
        pos += 12 + n
    w, h, depth, ctype, _, _, interlace = hdr
    if (depth, ctype, interlace) != (8, 2, 0):
        raise ValueError(f"unsupported PNG: depth {depth}, colour type "
                         f"{ctype}, interlace {interlace}")
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    raw = raw.reshape(h, w * 3 + 1)
    if raw[:, 0].any():
        raise ValueError("unsupported PNG: a row filter other than 0")
    return raw[:, 1:].reshape(h, w, 3).copy()


VIEWER_SECONDS = 3.0  # how long viewer_path serves before it reads


def viewer_path(scene, tables) -> dict:
    """The HTTP viewer on the interactive preset (captured), served on a
    free 127.0.0.1 port for VIEWER_SECONDS: frames that advance, ``/stats``,
    ``/frame.png`` decoded to the frame's size, and an ``/input`` move
    that moves the camera.  Then the display fetch alone: ``image(uint8=
    True)`` and its copy into pinned memory, and the PNG encode at zlib
    levels 1 (the viewer's) and 6 (the CLI's)."""
    cfg = interactive_config()
    ren = tr.Renderer(scene, cfg, tables=tables)
    cam = camera_for_pose(0)
    v = viewer.HttpViewer(ren, cam, port=0)
    reset_launches(ren)
    url = v.start()
    try:
        t_end = time.time() + VIEWER_SECONDS
        while v.frames < 3 and time.time() < t_end + 60:
            time.sleep(0.05)
        time.sleep(max(0.0, t_end - time.time()))
        stats0 = json.loads(urllib.request.urlopen(url + "stats",
                                                   timeout=30).read())
        png = urllib.request.urlopen(url + "frame.png", timeout=30).read()
        pos0 = cam.position.copy()
        req = urllib.request.Request(url + "input", method="POST",
                                     data=json.dumps({"move": [1, 0, 0]})
                                     .encode())
        urllib.request.urlopen(req, timeout=30).read()
        frames0 = v.frames
        t1 = time.time()
        while v.frames < frames0 + 3 and time.time() < t1 + 60:
            time.sleep(0.05)
        moved = not np.array_equal(cam.position, pos0)
        frames = v.frames
    finally:
        v.stop()
    launches = read_launches(ren, keys=LAUNCH_KEYS + NORMALS_KEYS)
    img = png_pixels(png)
    times = stats0["times"]
    log(f"viewer (preset 1920x1080, 131072 rays, captured) on "
        f"127.0.0.1:{v.port}: {stats0['frames']} frames in the first "
        f"{VIEWER_SECONDS:.0f} s, {frames} in all; ms/frame median "
        f"{np.median(times):.3f} (mean {np.mean(times):.3f}, over "
        f"{len(times)} frames); /frame.png {len(png)} bytes -> "
        f"{img.shape}; /input moved the camera: {moved}; launches "
        f"{launches}, {ren.replayed_steps} steps replayed")
    if not (stats0["frames"] >= 3 and frames >= frames0 + 3 and moved
            and img.shape == (cfg.height, cfg.width, 3)
            and launches["accumulate"] > 0
            and launches["traverse"] + launches["traverse_wave"] > 0):
        raise AssertionError(f"the viewer did not serve advancing frames: "
                             f"{stats0}, {frames}, {moved}, {img.shape}, "
                             f"{launches}")
    # the display fetch and the encode, alone
    ren.step(cam, 2)
    pinned = torch.empty((cfg.height, cfg.width, 3), dtype=torch.uint8,
                         pin_memory=DEV.type == "cuda")

    def fetch():
        pinned.copy_(ren.image(uint8=True), non_blocking=True)

    fetch_ms = cuda_ms(fetch, 10)
    host = pinned.numpy().copy()
    enc = {}
    for level in (1, 6):
        t0 = time.perf_counter()
        data = viewer._to_png_bytes(host, level)
        enc[level] = ((time.perf_counter() - t0) * 1e3, len(data))
        if not np.array_equal(png_pixels(data), host):
            raise AssertionError("the PNG does not decode to its image")
    log(f"display fetch 1920x1080: image(uint8=True) and the pinned copy "
        f"{fetch_ms:.3f} ms (CUDA events, 10 back to back); PNG encode "
        f"level 1 {enc[1][0]:.1f} ms ({enc[1][1]} bytes), level 6 "
        f"{enc[6][0]:.1f} ms ({enc[6][1]} bytes) (host clock)")
    return dict(frames_first_s=stats0["frames"], frames=frames,
                ms_per_frame_median=float(np.median(times)),
                ms_per_frame_mean=float(np.mean(times)),
                png_bytes=len(png), moved=moved, launches=launches,
                replayed_steps=ren.replayed_steps, fetch_ms=fetch_ms,
                encode_ms={str(k): v[0] for k, v in enc.items()},
                encode_bytes={str(k): v[1] for k, v in enc.items()})


def cli_path(steps: int = 16) -> dict:
    """The CLI on the loaded path's 1M-triangle PLY (with vertex normals)
    at the default 1920x1080 and 2,097,152 rays: ``render`` of ``steps``
    steps at pose 0 with ``--hdr`` .exr, its PNG decoded (zlib) bit for bit
    the ``Renderer``'s ``image(uint8=True)`` after the same steps and its
    EXR the radiance at half precision; ``info``; ``bvh-debug`` at 1080p;
    ``bench --seconds 1 --json``."""
    ply = str(SCENE_DIR / "terrain.ply")
    out_dir = TRACE_DIR / "cli"
    out_dir.mkdir(parents=True, exist_ok=True)
    png, exr = out_dir / "render.png", out_dir / "render.exr"
    common = ["--scene", ply, "--builder", "native"]
    cfg = RenderConfig()  # what the CLI builds from these flags
    _, err, render_s = run_cli(["render", *common, *pose_argv(0), "--steps",
                                str(steps), "--out", str(png),
                                "--hdr", str(exr)])
    launches = read_launches()
    step_line = [ln for ln in err.splitlines() if "step " in ln][-1]
    step_s = float(step_line.split()[2].rstrip("s"))
    img = png_pixels(png.read_bytes())
    # the same render through the Renderer
    t0 = time.perf_counter()
    sc = Scene.load(ply, builder="native")
    n_tris = sc.stats["triangles"]
    ren = tr.Renderer(sc, cfg)
    del sc
    load_s = time.perf_counter() - t0
    ren.step(camera_for_pose(0), steps)
    want = ren.image(uint8=True).cpu().numpy()
    rad = ren.radiance().cpu().numpy()
    hdr = read_exr(str(exr))
    if not np.array_equal(img, want):
        raise AssertionError(f"the CLI's PNG differs from the Renderer's "
                             f"image on {int((img != want).sum())} values")
    if not np.array_equal(hdr, rad.astype(np.float16).astype(np.float32)):
        raise AssertionError("the CLI's EXR is not the radiance")
    step_ms = cuda_ms(lambda: ren.step(camera_for_pose(0), 8), 1) / 8
    del ren
    log(f"cli render (the loaded PLY, 1920x1080, 2097152 rays, {steps} "
        f"steps, captured): {render_s:.2f} s in all, the steps "
        f"{step_s * 1e3 / steps:.3f} ms/step by its own clock (the "
        f"capture's warm-up step included); the Renderer on the same "
        f"scene {step_ms:.3f} ms/step after (CUDA events, 8 steps); PNG "
        f"{png.stat().st_size} bytes bit for bit the Renderer's image, EXR "
        f"{exr.stat().st_size} bytes its radiance; eager launches "
        f"{launches} (the capture's warm-up step; the rest replays it); "
        f"the scene loaded again in {load_s:.2f} s")
    if not (launches["traverse"] > 0 and launches["accumulate"] > 0):
        raise AssertionError(f"cli render launched no kernel: {launches}")

    info, _, info_s = run_cli(["info", *common])
    rows = [ln for ln in info.splitlines() if "kernel tables:" in ln]
    tris = [ln for ln in info.splitlines() if "bvh.triangles:" in ln]
    log(f"cli info ({info_s:.2f} s): " + " | ".join(
        ln.strip() for ln in info.splitlines()
        if ln.strip().startswith(("bvh.triangles", "bvh.nodes", "lights",
                                  "device memory", "kernel tables",
                                  "features"))))
    if not (rows and tris and int(tris[0].split(":")[1]) == n_tris):
        raise AssertionError(f"cli info: {info}")

    heat = out_dir / "bvh_debug.png"
    _, err, dbg_s = run_cli(["bvh-debug", *common, *pose_argv(0), "--out",
                             str(heat)])
    himg = png_pixels(heat.read_bytes())
    vline = [ln for ln in err.splitlines() if ln.startswith("visits:")][0]
    log(f"cli bvh-debug 1920x1080 ({dbg_s:.2f} s, the plain walk on the "
        f"card): {vline}; heatmap {himg.shape}, {int((himg[..., 1] > 0).sum())}"
        f" green and {int((himg[..., 0] > 0).sum())} red pixels")
    if himg.shape != (cfg.height, cfg.width, 3) or not himg.any():
        raise AssertionError(f"cli bvh-debug: {vline}, {himg.shape}")

    bench_out, _, bench_s = run_cli(["bench", *common, "--seconds", "1",
                                     "--json"])
    blaunch = read_launches()
    d = json.loads(bench_out.strip().splitlines()[-1])
    log(f"cli bench --seconds 1 --json ({bench_s:.2f} s): " + ", ".join(
        f"pose {p['pose']} {p['avg_ms']:.3f} ms/step "
        f"{p['total_mrays_per_s']:.3f} Mrays/s" for p in d["poses"])
        + f"; launches {blaunch}")
    if len(d["poses"]) != 3 or not d["total_mrays_per_s"] > 0 \
            or not blaunch["traverse"]:
        raise AssertionError(f"cli bench: {d}, {blaunch}")
    return dict(render_s=render_s, render_ms_per_step_cli=step_s * 1e3 / steps,
                renderer_ms_per_step=step_ms, render_launches=launches,
                load_s=load_s, info_s=info_s, bvh_debug_s=dbg_s,
                bvh_debug=vline, bench_s=bench_s, bench=d,
                bench_launches=blaunch)


def strips_path(scene, tables, cfg: RenderConfig, reps: int = 8) -> dict:
    """The strip-parallel path on the card: ``ShardedRenderer`` with one
    strip (``["cuda:0"]``) for 4 steps bit for bit the eager ``Renderer``;
    two strips (``["cuda:0"] * 2``: 1920x540 each, the full queue each) at
    full width, ms/step over ``reps`` steps after 2 and each strip's
    kernel launches; then the two strips at 32x32 on the card against the
    same two strips on the CPU."""
    cam = camera_for_pose(0)
    one = sharded.ShardedRenderer(scene, cfg, devices=["cuda:0"],
                                  tables=tables)
    ren = tr.Renderer(scene, cfg, tables=tables)
    reset_launches()
    one.step(cam, 4)
    torch.cuda.synchronize()
    one_launch = read_launches()
    ren.step(cam, 4)
    torch.cuda.synchronize()
    if not states_equal(one.states[0], ren.state):
        bad = [k for k in STATE_FIELDS if not torch.equal(
            getattr(one.states[0], k), getattr(ren.state, k))]
        raise AssertionError(f"one strip differs from the Renderer in {bad}")
    del one, ren
    log(f"strips, one strip on cuda:0: bit for bit the eager Renderer on "
        f"every RenderState field after 4 steps; launches {one_launch}")
    if one_launch["traverse"] != 8 or one_launch["accumulate"] != 4:
        raise AssertionError(f"one strip's launches: {one_launch}")

    two = sharded.ShardedRenderer(scene, cfg, devices=["cuda:0"] * 2,
                                  tables=tables)
    two.step(cam, 2)
    torch.cuda.synchronize()
    reset_launches()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0 = time.perf_counter()
    a.record()
    two.step(cam, reps)
    b.record()
    torch.cuda.synchronize()
    ms = a.elapsed_time(b) / reps
    wall = (time.perf_counter() - t0) * 1e3 / reps
    total = read_launches()
    # one more step through the strips' step function, split by strip
    per_strip = [{} for _ in two.mesh]
    step = sharded.make_sharded_step(cfg, two.mesh)
    two.states = step(two.states, two.replicas,
                      {d: cam.to_device(cfg, d) for d in two.replicas},
                      launches=per_strip)
    img = two.image()
    counted = sum(float(st.accum[:, 3].double().sum()) for st in two.states)
    log(f"strips, two on cuda:0 (1920x540 each, {cfg.num_rays} rays each): "
        f"{ms:.3f} ms/step (host {wall:.3f}) over {reps} steps, CUDA "
        f"events; launches {total}, by strip in one more step {per_strip}; "
        f"image {tuple(img.shape)}; {counted:.0f} paths counted over "
        f"{reps + 3} steps")
    if total["traverse"] != 4 * reps or total["accumulate"] != 2 * reps \
            or per_strip != [{"traverse": 2, "accumulate": 1, "shade": 1,
                              "spheres_closest": 1, "spheres_any": 1}] * 2 \
            or not bool(torch.isfinite(img).all()) \
            or tuple(img.shape) != (cfg.height, cfg.width, 3):
        raise AssertionError(f"two strips: {total}, {per_strip}, "
                             f"{img.shape}")
    del two

    # the two strips at 32x32, card against CPU (phase 4's small terrain)
    small = dataclasses.replace(cfg, width=32, height=32, num_rays=16_384)
    sc = Scene.from_triangles(*terrain(n_quads=48, towers=4))
    imgs = []
    for devs in (["cuda:0"] * 2, ["cpu"] * 2):
        r = sharded.ShardedRenderer(sc, small, devices=devs)
        r.step(cam, 6)
        imgs.append(r.image().cpu())
    mad = float((imgs[0] - imgs[1]).abs().mean())
    log(f"strips card vs cpu, two strips at 32x32/16384 rays/6 steps: mean "
        f"|diff| {mad:.3g}")
    if not mad < 0.03:
        raise AssertionError(f"two strips: card and CPU differ: {mad}")
    return dict(one_strip_bit_for_bit=True, one_strip_launches=one_launch,
                two_ms_per_step=ms, two_wall_ms_per_step=wall,
                two_launches=total, two_strip_launches=per_strip,
                card_vs_cpu=mad)


def load_example(name: str):
    """``examples/<name>.py`` as a module (the folder is not a package)."""
    path = ROOT / "examples" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"example_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def bench_entry() -> dict:
    """The examples ``render_spheres_torch`` and ``render_instances_torch``
    at their defaults, the latter on a 65,536-triangle terrain PLY (eight
    instances, 524,288 triangles), each PNG decoded and each counted from
    0 (the Renderer's eager steps).  ``bench_torch.bench_scene`` runs in
    the pose harness above."""
    folder = TRACE_DIR / "examples"
    folder.mkdir(parents=True, exist_ok=True)
    mesh = SCENE_DIR / "terrain_65k.ply"
    mesh.parent.mkdir(parents=True, exist_ok=True)
    scene_files.write_ply(mesh, *benchmark_scene(65_536))
    examples = {}
    for name, kw in (("render_spheres_torch", {}),
                     ("render_instances_torch", {"mesh": str(mesh)})):
        mod = load_example(name)
        png = folder / f"{name}.png"
        reset_launches()
        t0 = time.perf_counter()
        img = mod.render(out=str(png), **kw)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = read_launches()
        pixels = png_pixels(png.read_bytes())
        mean = float(pixels.mean())
        log(f"{name} at its defaults ({img.shape[1]}x{img.shape[0]}): "
            f"{secs:.1f} s, PNG mean {mean:.2f}, launches {launches}")
        if pixels.shape != img.shape or not 0 < mean < 255:
            raise AssertionError(f"{name}'s PNG: {pixels.shape}, mean {mean}")
        if not (launches["traverse"] and launches["accumulate"]):
            raise AssertionError(f"{name} missed a kernel: {launches}")
        examples[name] = dict(seconds=secs, png_mean=mean, launches=launches)
    return examples


def light_table_mb(sd) -> float:
    """Device MB of the light tables."""
    return sum(getattr(sd, k).numel() * 4 for k in (
        "tri_lights", "delta_lights", "light_powers", "light_alias",
        "env_data", "env_alias")) / 1e6


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    gpu = gpu_line()
    log(gpu)
    build_s = phase0()

    t0 = time.perf_counter()
    v0, v1, v2 = benchmark_scene(1_048_576)
    scene_host = Scene.from_triangles(v0, v1, v2)
    cfg = RenderConfig()  # fuse_step_chains="auto": captured on the card
    # the phases that split the step by stage run it eagerly
    cfg_eager = dataclasses.replace(cfg, fuse_step_chains="off")
    torch.cuda.reset_peak_memory_stats()
    ren = tr.Renderer(scene_host, cfg_eager)
    peak_mb = torch.cuda.max_memory_allocated() / 1e6
    log(f"scene: {scene_host.stats['triangles']} triangles, "
        f"{ren.scene.bvh.n_nodes} nodes, {ren.tables.rows.shape[0]} fat rows, "
        f"max depth {ren.tables.max_depth}, built+uploaded in "
        f"{time.perf_counter() - t0:.1f} s")
    tb = ren.tables
    log(f"kernel-side table: nodes {tb.nodes.numel() * 4 / 1e6:.1f} MB "
        f"({tb.nodes.shape[0]} x 64 B), triangles "
        f"{tb.tris.numel() * 4 / 1e6:.1f} MB ({tb.tris.shape[0]} x 48 B); "
        f"the fat rows {tb.rows.numel() * 4 / 1e6:.1f} MB on "
        f"{tb.rows.device}; device memory after building the Renderer: "
        f"peak {peak_mb:.1f} MB")

    # seconds a path takes, for the script's time budget
    secs, last = {}, [time.perf_counter()]

    def mark(name):
        now = time.perf_counter()
        secs[name] = round(now - last[0], 2)
        last[0] = now

    p1 = phase1(ren.scene, ren.tables)
    eq = gate(ren.scene)
    acc = phase2(cfg.num_pixels, cfg.num_rays)
    trace_ring_check()
    mark("phases 1, gate, 2")
    poses, launches = phase3(ren)
    # the wave generation at one pose: its kernel's checks come below
    ren_w = tr.Renderer(ren.scene, dataclasses.replace(
        cfg_eager, packet_kernel_mode="wave"), tables=ren.tables)
    poses_w, launches_w = phase3(ren_w, (0,))
    compare_in_step(poses, poses_w)
    del ren_w
    mark("phase 3")
    cap = captured_step(ren.scene, ren.tables, cfg)
    compare_captured(poses, cap["poses"])
    mark("captured")
    sl = kernels_at_slice(ren)
    shd = {"tri_shade": shade_at_step(ren)}
    sph = {"main": spheres_at_slice(ren)}
    mark("kernels at the slice")
    disp = display_path(ren.scene, ren.tables, dataclasses.replace(
        cfg, denoise="on", bloom_strength=0.1, packet_kernel_mode="wave"))
    mark("display")
    # the interactive preset on the main scene
    preset = interactive_config()
    if not ren.scene.tri_default_mat:
        raise AssertionError("the main scene's triangles are not all of "
                             "the default material")
    ren_p = tr.Renderer(ren.scene, dataclasses.replace(
        preset, fuse_step_chains="off"), tables=ren.tables)
    nrm = normals_at_extend(ren_p)
    shd["kernel_normals"] = shade_at_step(ren_p)
    sph["preset"] = spheres_at_slice(ren_p)
    del ren_p
    fly = flythrough(ren.scene, ren.tables, preset)
    mark("preset and fly-through")
    mad = phase4()
    mad_dn = phase4(denoise_wave=True)
    mark("phase 4")
    bench = bench_path(ren.scene, cfg, float(np.mean(
        [p["mrays_per_s"] for p in cap["poses"]])))
    mark("pose harness")
    prof = stage_profile_check(ren, poses[0]["device_split_ms"],
                               poses[0]["device_busy_ms_per_step"])
    view = viewer_path(ren.scene, ren.tables)
    mark("front ends: stage_profile, viewer")
    strips = strips_path(ren.scene, ren.tables, cfg_eager)
    mark("strips")
    del ren
    torch.cuda.empty_cache()
    ld = loaded_path(cfg_eager)
    mark("loaded")
    sf = sphere_free_path(cfg_eager)
    mark("sphere-free")
    fe_cli = cli_path()
    mark("front ends: cli")
    be = bench_entry()
    mark("bench entry")
    lt = lights_path(scene_host, cfg)
    mark("lights")
    fg = fog_path(scene_host, cfg)
    mark("fog")
    smp = sampling_path(scene_host, cfg)
    mark("sampling")
    del scene_host
    torch.cuda.empty_cache()
    tx = textures_path(cfg)
    mark("textures")
    log(f"seconds by path (build {build_s:.1f} s before): {secs}")

    queues = ("extend", "connect", "aov")

    def gen_checks(gen):
        return [p1[gen]["closest"], p1[gen]["any"]] \
            + [sl[q][gen] for q in queues]

    def entry(gen):
        checks = gen_checks(gen)
        closest = [p1[gen]["closest"], sl["extend"][gen], sl["aov"][gen]]
        return dict(max_abs_err=max(c["max_dt"] for c in closest),
                    mismatches=sum(c["mismatches"] for c in checks),
                    ties=sum(c["ties"] for c in closest),
                    rays_checked=sum(c["rays"] for c in checks),
                    ms=sl["extend"][gen]["ms"],
                    plain_ms=sl["extend"]["plain_ms"],
                    bound_ms=sl["extend"]["bound_ms"],
                    bound_by=sl["extend"]["bound_by"], library_ms=None,
                    # the loaded and the sphere-free scene's queues
                    loaded={q: queue_entry(ld["queues"][q], gen)
                            for q in queues},
                    sphere_free={q: queue_entry(sf["queues"][q], gen)
                                 for q in queues},
                    lights={case: {q: queue_entry(lt[case]["queues"][q], gen)
                                   for q in queues} for case in lt},
                    textures={q: queue_entry(tx["queues"][q], gen)
                              for q in queues},
                    fog={q: queue_entry(fg["queues"][q], gen)
                         for q in queues},
                    sampling={m: {q: queue_entry(smp["queues"][m][q], gen)
                                  for q in queues} for m in smp["queues"]})

    def queue_entry(q, gen):
        return dict(ms=q[gen]["ms"], plain_ms=q["plain_ms"],
                    bound_ms=q["bound_ms"], bound_by=q["bound_by"],
                    rays=q["rays"], mismatches=q[gen]["mismatches"])

    stream_checks = [p1["stream"]["closest"], sl["extend"]["stream"],
                     sl["aov"]["stream"]]
    stream_entry = dict(
        max_abs_err=max(c["max_abs_err"] for c in stream_checks),
        mismatches=sum(c["mismatches"] for c in stream_checks),
        ties=sum(c["ties"] for c in stream_checks),
        rays_checked=sum(c["rays"] for c in stream_checks),
        ms=sl["extend"]["stream"]["ms"],
        kernel_ms=sl["extend"]["stream"]["kernel_ms"],
        plain_ms=sl["extend"]["stream"]["plain_ms"],
        bound_ms=sl["extend"]["bound_ms"],
        bound_by=sl["extend"]["bound_by"],
        frontier_floor_ms=sl["extend"]["stream"]["frontier_floor_ms"],
        library_ms=None)
    at_step = sl["accumulate"]

    def step_entry(q):
        return {k: q[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                  "library_ms", "live", "distinct")}

    def normals_entry(gen, run):
        n = nrm[gen]
        return dict(normals_launches=fly[run]["launches"][
                        f"{'traverse_wave' if gen == 'wave' else 'traverse'}"
                        "_normals"],
                    normals_replaces="tyrant_tpu/ops/pallas/"
                                     "traverse_kernel.py:930",
                    normals={"max_abs_err": n["normals_max_abs_err"],
                             "mismatches": n["mismatches"],
                             "rays": nrm["rays"], "hits": nrm["hits"],
                             "ms": n["ms"],
                             "ms_without_normals": n["ms_without_normals"],
                             "plain_ms": nrm["plain_ms"],
                             "bound_ms": nrm["bound_ms"],
                             "bound_by": nrm["bound_by"]})

    def lights_launches(key, *runs):
        """A kernel's launches on the lights path, both configurations,
        over the named runs (eager and captured phase 3, the wave run)."""
        return sum(lt[c]["launches"][r][key] for c in lt for r in runs)

    def path_launches(path, key, *runs):
        """A kernel's launches on the textures or the fog path over the
        named runs (eager and captured phase 3, the wave run; the fog
        path's run with the lights)."""
        return sum(path["launches"][r][key] for r in runs)

    def sampling_launches(*keys):
        """A kernel's launches on the sampling path, every run of it (the
        blurred fly-throughs included), summed over ``keys``."""
        runs = list(smp["launches"].values()) + [
            f["launches"] for f in smp["blur_flythrough"].values()]
        return sum(r.get(k, 0) for r in runs for k in keys)

    def frontend_launches(key):
        """A kernel's launches on the front ends and the strips: the CLI's
        render (its eager warm-up step) and bench, the viewer (replays
        counted), one strip, and the two strips' timed steps and the step
        split by strip."""
        return {"cli_launches": fe_cli["render_launches"][key]
                + fe_cli["bench_launches"][key],
                "bench_entry_launches": sum(e["launches"][key]
                                            for e in be.values()),
                "viewer_launches": view["launches"][key],
                "strips_launches": strips["one_strip_launches"][key]
                + strips["two_launches"][key]
                + sum(sl.get(key, 0) for sl in strips["two_strip_launches"])}

    regs = build.registers()
    result = {"kernels": [
        {"name": "traverse", "route": "cuda",
         "source": "tyrant_tpu_torch/csrc/traverse.cu",
         "replaces": "tyrant_tpu/ops/pallas/traverse_kernel.py:164",
         # the main cell captured: the replays' launches counted
         "launches": cap["launches"]["traverse"],
         "eager_launches": launches["traverse"],
         "loaded_launches": ld["launches"]["mono"]["traverse"],
         "sphere_free_launches": sf["launches"]["traverse"],
         "flythrough_launches": fly["normals-on-auto"]["launches"][
             "traverse"],
         "lights_launches": lights_launches("traverse", "eager", "captured"),
         "textures_launches": path_launches(tx, "traverse", "eager",
                                            "captured"),
         "fog_launches": path_launches(fg, "traverse", "eager", "captured",
                                       "lights"),
         "sampling_launches": sampling_launches("traverse"),
         **frontend_launches("traverse"),
         "registers": {k: v for k, v in regs.items()
                       if k.startswith("traverse_kernel<")},
         **entry("mono"), **normals_entry("mono", "normals-on-auto")},
        {"name": "traverse_wave", "route": "cuda",
         "source": "tyrant_tpu_torch/csrc/traverse_wave.cu",
         "replaces": "tyrant_tpu/ops/pallas/traverse_kernel.py:646",
         "launches": launches_w["traverse_wave"],
         "display_launches": disp["launches"]["traverse_wave"],
         "display_captured_launches": disp["captured"]["launches"][
             "traverse_wave"],
         "loaded_launches": ld["launches"]["wave"]["traverse_wave"],
         "lights_launches": lights_launches("traverse_wave", "wave"),
         "textures_launches": path_launches(tx, "traverse_wave", "wave"),
         "fog_launches": path_launches(fg, "traverse_wave", "wave"),
         "sampling_launches": sampling_launches("traverse_wave"),
         "registers": {k: v for k, v in regs.items()
                       if k.startswith("traverse_wave_kernel<")},
         **entry("wave"), **normals_entry("wave", "normals-on-wave-auto")},
        {"name": "accumulate", "route": "cuda",
         "source": "tyrant_tpu_torch/csrc/accum.cu",
         "replaces": "tyrant_tpu/ops/pallas/accum_kernel.py:50",
         "launches": cap["launches"]["accumulate"],
         "eager_launches": launches["accumulate"],
         "flythrough_launches": fly["normals-on-auto"]["launches"][
             "accumulate"],
         "loaded_launches": ld["launches"]["mono"]["accumulate"]
         + ld["launches"]["wave"]["accumulate"],
         "sphere_free_launches": sf["launches"]["accumulate"],
         "lights_launches": lights_launches("accumulate", "eager",
                                            "captured", "wave"),
         "textures_launches": path_launches(tx, "accumulate", "eager",
                                            "captured", "wave"),
         "fog_launches": path_launches(fg, "accumulate", "eager", "captured",
                                       "wave", "lights"),
         "sampling_launches": sampling_launches("accumulate",
                                                "accumulate_moment2"),
         "moment2_launches": sampling_launches("accumulate_moment2"),
         **frontend_launches("accumulate"),
         "registers": {k: v for k, v in regs.items()
                       if k.startswith("accum_kernel")},
         "max_abs_err": max(acc["max_abs_err"], at_step["max_abs_err"],
                            ld["queues"]["accumulate"]["max_abs_err"],
                            sf["queues"]["accumulate"]["max_abs_err"],
                            *(lt[c]["queues"]["accumulate"]["max_abs_err"]
                              for c in lt),
                            tx["queues"]["accumulate"]["max_abs_err"],
                            fg["queues"]["accumulate"]["max_abs_err"],
                            smp["moment2_step_queue"]["max_abs_err"],
                            *(q["accumulate"]["max_abs_err"]
                              for q in smp["queues"].values())),
         "ms": acc["ms"], "kernel_ms": acc["kernel_ms"],
         "plain_ms": acc["plain_ms"], "bound_ms": acc["bound_ms"],
         "bound_by": acc["bound_by"], "library_ms": acc["library_ms"],
         # the step's queue: the kernel alone is the accumulate stage's one
         # kernel in phase 3's trace of pose 0 (mono), the main path's own
         "step_queue": {"ms": at_step["ms"],
                        "kernel_ms": poses[0]["device_split_ms"]["accumulate"],
                        "plain_ms": at_step["plain_ms"],
                        "bound_ms": at_step["bound_ms"],
                        "bound_by": at_step["bound_by"],
                        "library_ms": at_step["library_ms"],
                        "live": at_step["live"],
                        "distinct": at_step["distinct"]},
         "loaded_step_queue": step_entry(ld["queues"]["accumulate"]),
         "sphere_free_step_queue": step_entry(sf["queues"]["accumulate"]),
         "lights_step_queue": {c: step_entry(lt[c]["queues"]["accumulate"])
                               for c in lt},
         "textures_step_queue": step_entry(tx["queues"]["accumulate"]),
         "fog_step_queue": step_entry(fg["queues"]["accumulate"]),
         "sampling_step_queue": step_entry(
             smp["queues"]["sobol"]["accumulate"]),
         # the fused moment2 mode (accum_kernel<3,true>) on the adaptive
         # step's queue: the JAX step's second accumulate_sorted call
         "moment2_replaces": "tyrant_tpu/ops/pallas/accum_kernel.py:99",
         "moment2_step_queue": {
             k: smp["moment2_step_queue"][k]
             for k in ("ms", "kernel_ms_warm_l2", "plain_ms", "bound_ms",
                       "bound_by", "library_ms", "live", "distinct")}},
        {"name": "stream", "route": "cuda",
         "source": "tyrant_tpu_torch/csrc/stream.cu",
         "replaces": "tyrant_tpu/ops/pallas/stream_kernel.py:105",
         "launches": eq["launches"]["stream"], **stream_entry},
        {"name": "shade", "route": "cuda",
         "source": "tyrant_tpu_torch/csrc/shade.cu",
         # the JAX package's shade stage, which XLA fuses
         "replaces": "tyrant_tpu/render.py:1746",
         "launches": cap["launches"]["shade"],
         "eager_launches": launches["shade"],
         "wave_launches": launches_w["shade"],
         "display_launches": disp["launches"]["shade"],
         "display_captured_launches": disp["captured"]["launches"]["shade"],
         "flythrough_launches": fly["normals-on-auto"]["launches"]["shade"],
         "loaded_launches": ld["launches"]["mono"]["shade"]
         + ld["launches"]["wave"]["shade"],
         "sphere_free_launches": sf["launches"]["shade"],
         "lights_launches": lights_launches("shade", "eager", "captured",
                                            "wave"),
         "textures_launches": path_launches(tx, "shade", "eager",
                                            "captured", "wave"),
         "fog_launches": path_launches(fg, "shade", "eager", "captured",
                                       "wave", "lights"),
         "sampling_launches": sampling_launches("shade"),
         **frontend_launches("shade"),
         "registers": {k: v for k, v in regs.items()
                       if k.startswith("shade_kernel<")},
         "mismatches": sum(sum(q["mismatches"].values())
                           for q in shd.values()),
         "rays_checked": sum(q["rays"] for q in shd.values()),
         **{k: shd["tri_shade"][k] for k in ("ms", "kernel_ms", "plain_ms",
                                             "bound_ms", "bound_by",
                                             "library_ms")},
         "kernel_normals": {k: shd["kernel_normals"][k]
                            for k in ("rays", "ms", "kernel_ms", "plain_ms",
                                      "bound_ms", "bound_by", "library_ms",
                                      "mismatches")}},
        {"name": "shade_textured", "route": "cuda",
         "source": "tyrant_tpu_torch/csrc/shade_textured.cu",
         "replaces": "tyrant_tpu/render.py:1746",
         # the textures path: its shade kernel's launches (the surface
         # kernel's are counted apart), captured with the replays, eager
         # and with the wave kernel
         "launches": tx["launches"]["captured"]["shade_textured"],
         "eager_launches": tx["launches"]["eager"]["shade_textured"],
         "wave_launches": tx["launches"]["wave"]["shade_textured"],
         "surface_launches": path_launches(tx, "shade_surface", "eager",
                                           "captured", "wave"),
         "registers": {k: regs.get(k) for k in ("surface_kernel",
                                                "shade_textured_kernel")},
         # the queue under "bilinear", the cell's filter; then "nearest"
         **{k: tx["at_step"]["bilinear"][k] for k in TEXTURED_AT_STEP},
         "nearest": {k: tx["at_step"]["nearest"][k]
                     for k in TEXTURED_AT_STEP},
         # both queues' slots off, all fields
         "mismatches": sum(sum(q["mismatches"].values())
                           for q in tx["at_step"].values()),
         "rays_checked": sum(q["rays"] for q in tx["at_step"].values())},
        {"name": "spheres", "route": "cuda",
         "source": "tyrant_tpu_torch/csrc/spheres.cu",
         # no TPU kernel: the JAX package's sphere tests are XLA fusions
         "replaces": None,
         # the main cell captured (replays counted), then eager
         "launches": {k: cap["launches"][k] for k in SPHERE_KEYS},
         "eager_launches": {k: launches[k] for k in SPHERE_KEYS},
         "registers": {k: v for k, v in regs.items()
                       if k.startswith("spheres_kernel<")},
         "mismatches": sum(q["closest"]["t_mismatches"]
                           + q["closest"]["id_mismatches"]
                           + q["any"]["mismatches"] for q in sph.values()),
         "rays_checked": sum(2 * q["rays"] for q in sph.values()),
         # the main cell's 2M queue, then the preset's 131k queue
         **{mode: sph["main"][mode] for mode in ("closest", "any")},
         "preset": {mode: sph["preset"][mode]
                    for mode in ("closest", "any")}}]}
    log(json.dumps({"poses": poses, "poses_wave": poses_w,
                    "queues": {q: sl[q] for q in queues + ("accumulate",)},
                    "phase2": acc,
                    "phase1": p1, "gate": eq, "harness": bench,
                    "display": disp, "card_vs_cpu": mad,
                    "card_vs_cpu_denoised_wave": mad_dn, "build_s": build_s,
                    "renderer_peak_mb": peak_mb, "loaded": ld,
                    "sphere_free": sf, "lights": lt, "captured": cap,
                    "textures": tx, "fog": fg, "sampling": smp,
                    "preset_normals": nrm, "flythrough": fly,
                    "shade": shd, "spheres": sph,
                    "registers": regs, "stage_profile": prof,
                    "viewer": view, "cli": fe_cli, "strips": strips,
                    "bench_entry": be,
                    "seconds_by_path": secs}))
    log(gpu)
    log(json.dumps(result))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
