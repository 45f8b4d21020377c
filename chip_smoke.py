"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Builds the port's CUDA kernels from ``tyrant_tpu_torch/csrc``, holds each
against its plain PyTorch version on the card (on synthetic rays and on
the inputs the main path gives it: the extend queue, the shadow queue and
the AOV pass's primaries), runs the bench's equivalence gate (the three
traversal kernels, depth-first mono and wave and breadth-first stream,
against the plain walk) and the stream kernel's overflow check, renders
the main path at full size (1920x1080, 2,097,152-ray queue, 5 bounces,
the seven spheres plus the ~1M-triangle benchmark terrain) from the
benchmark's three poses with a profiled per-stage device-time split, once
with each traversal-kernel generation (``packet_kernel_mode`` "mono" and
"wave"), drives the denoised display path (AOV pass, à-trous denoiser,
bloom) at full size, compares small renders on the card with the same
renders on the CPU, and times the three poses with the pose harness.

Run from the root of the repository:

    python3 chip_smoke.py

Exits non-zero, without a result line, when CUDA is unavailable or any
phase fails.  The last line of standard output is
``{"ok": true, "device": {...}}``; the line before it holds the per-kernel
numbers, and the one before that the card's name and power limit.  The
profiler traces of phase 3 are left in ``build/chip_smoke/``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from tyrant_tpu_torch import render as tr  # noqa: E402
from tyrant_tpu_torch.bench import equivalence  # noqa: E402
from tyrant_tpu_torch.bench.harness import (results_to_dict,  # noqa: E402
                                            run_benchmark)
from tyrant_tpu_torch.bench.poses import camera_for_pose, mrays_per_s  # noqa: E402
from tyrant_tpu_torch.config import (EPSILON, RenderConfig,  # noqa: E402
                                     small_config)
from tyrant_tpu_torch.denoise import atrous_denoise  # noqa: E402
from tyrant_tpu_torch.ops import stream as plain_stream  # noqa: E402
from tyrant_tpu_torch.ops import traverse as plain_trav  # noqa: E402
from tyrant_tpu_torch.ops.intersect import intersect_spheres  # noqa: E402
from tyrant_tpu_torch.ops.kernels import accum as kacc  # noqa: E402
from tyrant_tpu_torch.ops.kernels import build  # noqa: E402
from tyrant_tpu_torch.ops.kernels import stream as kstream  # noqa: E402
from tyrant_tpu_torch.ops.kernels import traverse as ktrav  # noqa: E402
from tyrant_tpu_torch.ops.tonemap import bloom, resolve  # noqa: E402
from tyrant_tpu_torch.scene.procgen import benchmark_scene, terrain  # noqa: E402
from tyrant_tpu_torch.scene.scene import Scene  # noqa: E402

DEV = torch.device("cuda")
STAGES = ("raygen", "extend", "shade", "connect", "sort", "accumulate")
TIE = 1e-3  # hit distances closer than EPSILON: either id is right
TRACE_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke"
GENERATIONS = (("mono", False), ("wave", True))

# The card's peaks for the bound (NVIDIA's H100 SXM data sheet, at the
# 700 W limit): HBM3 bytes/s and float32 operations/s outside the tensor
# cores.  Operations a traversal needs, counted from the kernels' source:
# a slab test is 6 subtractions, 6 multiplications, 4 max/min and 3
# compares; a Möller-Trumbore test with its accept rule is 54 operations.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
SLAB_OPS, MT_OPS = 19, 54
# Table bytes a traversal must read: the depth-first kernels a 64-byte node
# record a distinct row and a 48-byte record a distinct triangle tested
# (ops/kernels/traverse.py:build_kernel_tables); the stream kernel the fat
# row itself, triangles included.
NODE_BYTES, TRI_BYTES, ROW_BYTES = 64, 48, 128 * 4


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of fn() over reps calls, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


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
    depth-first walk's (t_walk, id_walk) with the tie rule; timed beside
    the plain version.  ``cap_mult`` grows until the frontier fits."""
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
    (t_p, id_p, ovf_p), plain_ms = timed_once(
        lambda: plain_stream.closest_hit_stream(
            o, d, tables.rows, tables.max_depth, t, cap_mult, stats=stats_p))
    n_id = int((id_k != id_p).sum())
    n_t = int((t_k.view(torch.int32) != t_p.view(torch.int32)).sum())
    if n_id or n_t or int(ovf_p) or stats_k["pairs"] != stats_p["pairs"]:
        raise AssertionError(
            f"{what} stream against its plain version: {n_id} ids and {n_t} "
            f"t differ, plain overflow {int(ovf_p)}, pairs a level "
            f"{stats_k['pairs']} against {stats_p['pairs']}")
    vs_walk = check_closest(f"{what} stream vs walk", t_k, id_k, t_walk,
                            id_walk)
    before = kstream.launches
    kstream.closest_hit_stream(o, d, tables, t, cap_mult=cap_mult,
                               return_overflow=True)
    per_call = kstream.launches - before
    ms = cuda_ms(lambda: kstream.closest_hit_stream(
        o, d, tables, t, cap_mult=cap_mult, return_overflow=True), reps)
    n = o.shape[0]
    peak = max(stats_p["pairs"])
    log(f"{what} stream: kernel {ms:.4f} ms, plain {plain_ms:.3f} ms; 0 id "
        f"and 0 t differences against the plain version; {stats_p['levels']} "
        f"levels, peak frontier {peak} pairs ({peak / n:.3f}x the {n} rays) "
        f"at cap_mult={cap_mult}; {per_call} level launches a call; "
        f"{stats_p['box_tests']} boxes, {stats_p['tri_tests']} triangles")
    return dict(vs_walk, ms=ms, plain_ms=plain_ms, max_abs_err=0.0,
                cap_mult=cap_mult, levels=stats_p["levels"],
                pairs=stats_p["pairs"], peak_over_rays=peak / n,
                launches_per_call=per_call, box_tests=stats_p["box_tests"],
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


def bench_path(sd, cfg: RenderConfig, seconds_per_pose: float = 1.0) -> dict:
    """The pose harness on the main cell: all three poses, counted from 0."""
    reset_launches()
    results = run_benchmark(sd, cfg, seconds_per_pose=seconds_per_pose)
    torch.cuda.synchronize()
    launches = read_launches()
    d = results_to_dict(results)
    for r in d["poses"]:
        log(f"harness pose {r['pose']}: {r['avg_ms']:.3f} ms/step over "
            f"{r['frames']} steps ({r['min_ms']:.3f}-{r['max_ms']:.3f}, "
            f"spread {r['spread_pct']}%, {r['retries']} retries), "
            f"{r['total_mrays_per_s']:.3f} Mrays/s")
    log(f"harness launches: {launches}")
    log("harness: " + json.dumps(d))
    if len(results) != 3 or not all(
            np.isfinite(r.avg_ms) and r.avg_ms > 0 and r.total_mrays_per_s > 0
            for r in results):
        raise AssertionError(f"harness results: {d}")
    if not (launches["traverse"] and launches["accumulate"]) \
            or launches["stream"]:
        raise AssertionError(f"the harness did not run through the kernels: "
                             f"{launches}")
    return dict(d, launches=launches)


def phase2(p: int, n: int) -> dict:
    """Accumulation kernel against the plain version on CPU copies, timed
    beside the plain version and one index_add_ call."""
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
    if not torch.equal(got[:, 3], want[:, 3]):
        raise AssertionError("path counts differ")
    if not torch.allclose(got[:, :3], want[:, :3], rtol=1e-6, atol=0):
        raise AssertionError("rgb differs beyond rtol 1e-6")
    ms = cuda_ms(lambda: kacc.accumulate_sorted(acc_d, pix_d, vals_d), 20)
    plain_ms = cuda_ms(lambda: kacc.accumulate_plain(acc_d, pix_d, vals_d), 20)
    # the library call: one index_add_ into a buffer padded past the
    # sentinel, so the skipped entries land outside the first P rows
    acc_pad = torch.zeros((kacc.sentinel(p) + 1, 4), device=DEV)
    library_ms = cuda_ms(lambda: acc_pad.index_add_(0, pix_d, vals_d), 20)
    # each input read once, the buffer read and written once
    bnd, by = bound_ms(2 * p * 16 + n * 4 + n * 16, n * 4)
    log(f"phase 2 timing: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"index_add_ {library_ms:.4f} ms, bound {bnd:.4f} ms ({by})")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                library_ms=library_ms, bound_ms=bnd, bound_by=by)


def stage_split(trace_path: Path, steps: int) -> tuple[dict, float]:
    """Device ms per step of each stage of render_step, from a profiler
    trace: every kernel, copy and memset is charged to the stage whose
    ``record_function`` range was open on the host when it was launched.
    Returns (split, busy ms per step); ``split["other"]`` is device time
    launched outside the stage ranges."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    dev = {e["args"]["correlation"]: e["dur"] for e in events
           if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")}
    spans = [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
             if e.get("cat") == "user_annotation" and e["name"] in STAGES]
    split = dict.fromkeys(STAGES + ("other",), 0.0)
    for e in events:
        if e.get("cat") not in ("cuda_runtime", "cuda_driver"):
            continue
        us = dev.get(e.get("args", {}).get("correlation"))
        if us is None:
            continue
        stage = next((name for a, b, name in spans if a <= e["ts"] <= b),
                     "other")
        split[stage] += us
    busy = sum(dev.values())
    return ({k: v / 1e3 / steps for k, v in split.items()},
            busy / 1e3 / steps)


def reset_launches() -> None:
    ktrav.launches = ktrav.launches_wave = kacc.launches = 0
    kstream.launches = 0


def read_launches() -> dict:
    return {"traverse": ktrav.launches, "traverse_wave": ktrav.launches_wave,
            "accumulate": kacc.launches, "stream": kstream.launches}


def phase3(ren):
    """The main path at full size, with the traversal generation that
    ``ren.cfg.packet_kernel_mode`` selects: for each pose 4 warm-up steps,
    8 steps timed with CUDA events, then 2 steps under the profiler for
    the per-stage device-time split and the device's idle share."""
    cfg = ren.cfg
    wave = tr._pick_wave(cfg, "extend")
    tag = "wave" if wave else "mono"
    TRACE_DIR.mkdir(parents=True, exist_ok=True)
    # the profiler's first session sets up the device tracing; keep that
    # cost out of pose 0's window
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.ones(1, device=DEV).add_(1)
        torch.cuda.synchronize()
    reset_launches()
    total_steps = 0
    poses = []
    for i in range(3):
        cam = camera_for_pose(i)
        ended = torch.zeros((), dtype=torch.int64, device=DEV)

        def run(steps, cam=cam, ended=ended):
            for _ in range(steps):
                st = ren.step(cam, 1)
                ended.add_(cfg.num_rays - st.n_carried)

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

        trace = TRACE_DIR / f"trace_{tag}_pose{i}.json"
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            a.record()
            run(2)
            b.record()
            torch.cuda.synchronize()
        prof.export_chrome_trace(str(trace))
        window_ms = a.elapsed_time(b) / 2
        split, busy_ms = stage_split(trace, 2)
        idle = 1.0 - busy_ms / window_ms
        if not all(split[s] > 0 for s in STAGES):
            raise AssertionError(f"pose {i}: a stage ran nothing on the "
                                 f"device: {split}")
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
                          device_split_ms=split))
        log(f"phase 3 {tag} pose {i}: {ms:.3f} ms/step (host {wall_ms:.3f}), "
            f"{mr:.3f} Mrays/s, {shadow_n / 8:.0f} shadow rays/step, "
            f"{int(counted)} paths counted = ended")
        log(f"phase 3 {tag} pose {i} profiled: {window_ms:.3f} ms/step, "
            f"device busy {busy_ms:.3f} ms (idle {idle:.3f}); device ms "
            + " ".join(f"{k} {v:.3f}" for k, v in split.items()))
    launches = read_launches()
    log(f"phase 3 {tag} launches over {total_steps} steps: {launches}")
    want = {"traverse": 0 if wave else 2 * total_steps,
            "traverse_wave": 2 * total_steps if wave else 0,
            "accumulate": total_steps, "stream": 0}
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


def check_queue(what: str, o, d, t, tables, bvh, closest: bool,
                reps: int = 5) -> dict:
    """Both depth-first traversal kernels against the plain walk on one
    queue of the main path, and on a closest-hit queue the stream kernel
    (:func:`check_stream`): checked with the tie rule (closest) or exactly
    (any hit),
    timed with CUDA events, with the bound from the work the plain walk
    counts on these rays (distinct rows and triangles read, boxes and
    triangles tested): ``bound_ms`` for the depth-first kernels' node and
    triangle records, ``stream_bound_ms`` for the fat rows the stream
    kernel reads.
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
    s_bnd, s_by = bound_ms(ray_bytes + rows * ROW_BYTES, n_ops)
    out = dict(rays=n, live_rays=live, plain_ms=plain_ms, rows_read=rows,
               tris_read=tris, box_tests=stats["box_tests"],
               tri_tests=stats["tri_tests"], bytes=n_bytes, ops=n_ops,
               bound_ms=bnd, bound_by=by, stream_bound_ms=s_bnd,
               stream_bound_by=s_by, **counts)
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
    if closest:
        out["wave"]["ties_vs_mono"] = int(
            (out.pop("wave_ids") != out.pop("mono_ids")).sum())
        out["stream"] = check_stream(what, o, d, t, tables, t_p, id_p,
                                     reps=reps)
    log(f"{what} ({n} rays, {live} walked): mono {out['mono']['ms']:.4f} "
        f"ms, wave {out['wave']['ms']:.4f} ms"
        + (f", stream {out['stream']['ms']:.4f} ms" if closest else "")
        + f", plain {plain_ms:.3f} ms; bound "
        f"{bnd:.4f} ms ({by}: {rows} rows and {tris} triangles read, "
        f"{n_bytes / 1e6:.1f} MB, {n_ops / 1e9:.3f} G operations); with "
        f"the fat rows, for the stream kernel, {s_bnd:.4f} ms ({s_by})")
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


def kernels_at_slice(ren) -> dict:
    """The traversal kernels against the plain walk, compared and timed
    on the inputs the main path gives them in pose 0's next step (the
    stream kernel on the two closest-hit queues): the
    extend queue seeded with the sphere pass's t, the shadow queue that
    shade makes from those hits, and the AOV pass's pixel-centre
    primaries with their sphere t."""
    cfg, sc = ren.cfg, ren.scene
    cam = camera_for_pose(0)
    ren.step(cam, 1)
    camd = cam.to_device(cfg, DEV)
    rays = tr.merge_queue(cfg, ren.state, camd)
    o, d = rays["origin"], rays["direction"]
    t_sph, sph_id = intersect_spheres(o, d, sc.sphere_center, sc.sphere_radius)
    extend = check_queue("slice extend closest", o, d, t_sph, ren.tables,
                         sc.bvh, closest=True)
    # the same rays without the sphere pass's t_init: how much the spheres
    # (the ground sphere above all) prune the BVH walk
    unseeded = {gen: cuda_ms(lambda wave=wave: ktrav.closest_hit_packets(
        o, d, ren.tables, wave=wave), 5) for gen, wave in GENERATIONS}
    log(f"slice extend without the sphere t_init: mono "
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
    connect = check_queue(f"slice connect any hit ({int(valid.sum())} valid)",
                          so, sd, maxd, ren.tables, sc.bvh, closest=False)

    ao, ad = tr.aov_primaries(camd, cfg)
    a_sph, _ = intersect_spheres(ao, ad, sc.sphere_center, sc.sphere_radius)
    aov = check_queue("slice AOV primaries closest", ao, ad, a_sph,
                      ren.tables, sc.bvh, closest=True)
    return dict(extend=dict(extend, unseeded_ms=unseeded), connect=connect,
                aov=aov)


def display_path(scene, tables, cfg: RenderConfig, steps: int = 8) -> dict:
    """The denoised display path with the wave kernel: ``steps`` steps at
    pose 0, then ``image()`` (AOV pass, à-trous denoiser, bloom, tone
    map), timed whole and by part with CUDA events."""
    ren = tr.Renderer(scene, cfg, tables=tables)
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
    if stepped != {"traverse": 0, "traverse_wave": 2 * steps,
                   "accumulate": steps, "stream": 0} or aov_launches != 1 \
            or launches["traverse"] != 0:
        raise AssertionError(f"the display path did not run through the "
                             f"kernels: {stepped} then {launches}")
    if tuple(img.shape) != (cfg.height, cfg.width, 3) \
            or not bool(torch.isfinite(img).all()) \
            or float(img.min()) < 0.0 or float(img.max()) > 1.0:
        raise AssertionError("the display image is not finite in [0, 1]")

    aovs = ren.aovs()
    mean = ren.radiance()
    aov_ms = cuda_ms(lambda: tr.render_aovs(ren.scene, ren._last_cam, cfg,
                                            ren.tables), 3)
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
    return dict(image_ms=image_ms, aov_ms=aov_ms, denoise_ms=dn_ms,
                bloom_ms=bloom_ms, launches=launches,
                mean_change=changed)


def phase4(denoise_wave: bool = False) -> float:
    """The card against the CPU at small size: the accumulation's
    resolve, or with ``denoise_wave`` the denoised display image rendered
    with the wave kernel on the card."""
    kw = dict(denoise="on", packet_kernel_mode="wave") if denoise_wave else {}
    cfg = small_config(width=64, height=64, num_rays=16_384, **kw)
    v0, v1, v2 = terrain(n_quads=48, towers=4)
    imgs = []
    for dev in ("cuda", "cpu"):
        ren = tr.Renderer(Scene.from_triangles(v0, v1, v2), cfg, device=dev)
        ren.step(camera_for_pose(0), 6)
        imgs.append(ren.image().cpu() if denoise_wave
                    else resolve(ren.state.accum.cpu(), cfg.width, cfg.height))
        if dev == "cuda":
            counts = ren.state.accum[:, 3].sum().item()
    mad = float((imgs[0] - imgs[1]).abs().mean())
    what = "denoised image() with wave" if denoise_wave else "resolve"
    log(f"phase 4 card vs cpu at 64x64/16384 rays/6 steps, {what}: mean "
        f"|diff| {mad:.3g} ({counts:.0f} paths on the card)")
    if not mad < 0.03:
        raise AssertionError(f"card and CPU renders differ: {mad}")
    return mad


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
    cfg = RenderConfig()
    ren = tr.Renderer(scene_host, cfg)
    log(f"scene: {scene_host.stats['triangles']} triangles, "
        f"{ren.scene.bvh.n_nodes} nodes, {ren.tables.rows.shape[0]} fat rows, "
        f"max depth {ren.tables.max_depth}, built+uploaded in "
        f"{time.perf_counter() - t0:.1f} s")
    tb = ren.tables
    log(f"kernel-side table: nodes {tb.nodes.numel() * 4 / 1e6:.1f} MB "
        f"({tb.nodes.shape[0]} x 64 B), triangles "
        f"{tb.tris.numel() * 4 / 1e6:.1f} MB ({tb.tris.shape[0]} x 48 B); "
        f"the fat rows {tb.rows.numel() * 4 / 1e6:.1f} MB")

    p1 = phase1(ren.scene, ren.tables)
    eq = gate(ren.scene)
    acc = phase2(cfg.num_pixels, cfg.num_rays)
    poses, launches = phase3(ren)
    ren_w = tr.Renderer(ren.scene, dataclasses.replace(
        cfg, packet_kernel_mode="wave"), tables=ren.tables)
    poses_w, launches_w = phase3(ren_w)
    compare_in_step(poses, poses_w)
    del ren_w
    sl = kernels_at_slice(ren)
    disp = display_path(ren.scene, ren.tables, dataclasses.replace(
        cfg, denoise="on", bloom_strength=0.1, packet_kernel_mode="wave"))
    mad = phase4()
    mad_dn = phase4(denoise_wave=True)
    bench = bench_path(ren.scene, cfg)

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
                    bound_by=sl["extend"]["bound_by"], library_ms=None)

    stream_checks = [p1["stream"]["closest"], sl["extend"]["stream"],
                     sl["aov"]["stream"]]
    stream_entry = dict(
        max_abs_err=max(c["max_abs_err"] for c in stream_checks),
        mismatches=sum(c["mismatches"] for c in stream_checks),
        ties=sum(c["ties"] for c in stream_checks),
        rays_checked=sum(c["rays"] for c in stream_checks),
        ms=sl["extend"]["stream"]["ms"],
        plain_ms=sl["extend"]["stream"]["plain_ms"],
        bound_ms=sl["extend"]["stream_bound_ms"],
        bound_by=sl["extend"]["stream_bound_by"], library_ms=None)
    result = {"kernels": [
        {"name": "traverse", "route": "cuda",
         "source": "tyrant_tpu_torch/csrc/traverse.cu",
         "replaces": "tyrant_tpu/ops/pallas/traverse_kernel.py:164",
         "launches": launches["traverse"], **entry("mono")},
        {"name": "traverse_wave", "route": "cuda",
         "source": "tyrant_tpu_torch/csrc/traverse_wave.cu",
         "replaces": "tyrant_tpu/ops/pallas/traverse_kernel.py:646",
         "launches": launches_w["traverse_wave"],
         "display_launches": disp["launches"]["traverse_wave"],
         **entry("wave")},
        {"name": "accumulate", "route": "cuda",
         "source": "tyrant_tpu_torch/csrc/accum.cu",
         "replaces": "tyrant_tpu/ops/pallas/accum_kernel.py:50",
         "launches": launches["accumulate"], "max_abs_err": acc["max_abs_err"],
         "ms": acc["ms"], "plain_ms": acc["plain_ms"],
         "bound_ms": acc["bound_ms"], "bound_by": acc["bound_by"],
         "library_ms": acc["library_ms"]},
        {"name": "stream", "route": "cuda",
         "source": "tyrant_tpu_torch/csrc/stream.cu",
         "replaces": "tyrant_tpu/ops/pallas/stream_kernel.py:105",
         "launches": eq["launches"]["stream"], **stream_entry}]}
    log(json.dumps({"poses": poses, "poses_wave": poses_w,
                    "queues": {q: sl[q] for q in queues},
                    "phase1": p1, "gate": eq, "harness": bench,
                    "display": disp, "card_vs_cpu": mad,
                    "card_vs_cpu_denoised_wave": mad_dn, "build_s": build_s}))
    log(gpu)
    log(json.dumps(result))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
