"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Builds the port's CUDA kernels from ``tyrant_tpu_torch/csrc``, holds each
against its plain PyTorch version on the card (on synthetic rays and on
the inputs the main path gives it), renders the main path at full size
(1920x1080, 2,097,152-ray queue, 5 bounces, the seven spheres plus the
~1M-triangle benchmark terrain) from the benchmark's three poses with a
profiled per-stage device-time split, and compares a small render on the
card with the same render on the CPU.

Run from the root of the repository:

    python3 chip_smoke.py

Exits non-zero, without a result line, when CUDA is unavailable or any
phase fails.  The last line of standard output is
``{"ok": true, "device": {...}}``; the line before it holds the per-kernel
numbers, and the one before that the card's name and power limit.  The
profiler traces of phase 3 are left in ``build/chip_smoke/``.
"""

from __future__ import annotations

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
from tyrant_tpu_torch.bench.poses import camera_for_pose, mrays_per_s  # noqa: E402
from tyrant_tpu_torch.config import RenderConfig, small_config  # noqa: E402
from tyrant_tpu_torch.ops import traverse as plain_trav  # noqa: E402
from tyrant_tpu_torch.ops.intersect import intersect_spheres  # noqa: E402
from tyrant_tpu_torch.ops.kernels import accum as kacc  # noqa: E402
from tyrant_tpu_torch.ops.kernels import build  # noqa: E402
from tyrant_tpu_torch.ops.kernels import traverse as ktrav  # noqa: E402
from tyrant_tpu_torch.ops.tonemap import resolve  # noqa: E402
from tyrant_tpu_torch.scene.procgen import benchmark_scene, terrain  # noqa: E402
from tyrant_tpu_torch.scene.scene import Scene  # noqa: E402

DEV = torch.device("cuda")
STAGES = ("raygen", "extend", "shade", "connect", "sort", "accumulate")
TIE = 1e-3  # hit distances closer than EPSILON: either id is right
TRACE_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke"


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


def phase1(scene, tables, n_rays: int = 65_536) -> tuple[dict, dict]:
    """Traversal kernel against the plain walk on bench.py's rays, with
    origins on box planes (NaN slab distances)."""
    o, d, span = bench_rays(scene.bvh, n_rays)
    t_k, id_k = ktrav.closest_hit_packets(o, d, tables)
    t_p, id_p = plain_trav.closest_hit(o, d, scene.bvh)
    closest = check_closest("phase 1 closest", t_k, id_k, t_p, id_p)
    if not closest["hits"]:
        raise AssertionError("phase 1: no ray hit the mesh")
    # hits: half with the max distance past the hit (occluded), half short
    # of it (clear); misses: the scene's span
    t_p, hits = t_p.cpu().numpy(), id_p.cpu().numpy() >= 0
    past = np.arange(n_rays) % 2 == 0
    maxd = torch.from_numpy(np.where(hits, np.where(past, t_p * 1.01 + 0.01,
                                                    t_p * 0.99), span)
                            .astype(np.float32)).to(DEV)
    active = torch.arange(n_rays, device=DEV) % 5 != 0
    occ_k = ktrav.any_hit_packets(o, d, maxd, tables, active=active)
    occ_p = plain_trav.any_hit(o, d, maxd, scene.bvh, active=active)
    anyhit = check_any("phase 1 any hit", occ_k, occ_p)
    if not anyhit["occluded"]:
        raise AssertionError("phase 1: no shadow ray was occluded")
    return closest, anyhit


def phase2(p: int, n: int):
    """Accumulation kernel against the plain version on CPU copies."""
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
    log(f"phase 2 timing: kernel {ms:.4f} ms, plain (index_add_) "
        f"{plain_ms:.4f} ms")
    return err, ms, plain_ms


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


def phase3(ren):
    """The main path at full size: for each pose 4 warm-up steps, 8 steps
    timed with CUDA events, then 2 steps under the profiler for the
    per-stage device-time split and the device's idle share."""
    cfg = ren.cfg
    TRACE_DIR.mkdir(parents=True, exist_ok=True)
    # the profiler's first session sets up the device tracing; keep that
    # cost out of pose 0's window
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.ones(1, device=DEV).add_(1)
        torch.cuda.synchronize()
    ktrav.launches = kacc.launches = 0
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

        trace = TRACE_DIR / f"trace_pose{i}.json"
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
        poses.append(dict(pose=i, ms_per_step=ms, wall_ms_per_step=wall_ms,
                          mrays_per_s=mr, shadow_rays_per_step=shadow_n / 8,
                          paths_counted=int(counted),
                          profiled_ms_per_step=window_ms,
                          device_busy_ms_per_step=busy_ms, idle_share=idle,
                          device_split_ms=split))
        log(f"phase 3 pose {i}: {ms:.3f} ms/step (host {wall_ms:.3f}), "
            f"{mr:.3f} Mrays/s, {shadow_n / 8:.0f} shadow rays/step, "
            f"{int(counted)} paths counted = ended")
        log(f"phase 3 pose {i} profiled: {window_ms:.3f} ms/step, device "
            f"busy {busy_ms:.3f} ms (idle {idle:.3f}); device ms "
            + " ".join(f"{k} {v:.3f}" for k, v in split.items()))
    launches = {"traverse": ktrav.launches, "accumulate": kacc.launches}
    log(f"phase 3 launches over {total_steps} steps: {launches}")
    if launches["traverse"] != 2 * total_steps \
            or launches["accumulate"] != total_steps:
        raise AssertionError(f"main path did not run through the kernels: "
                             f"{launches}")
    return poses, launches


def kernels_at_slice(ren):
    """The traversal kernel against its plain version, compared and timed
    on the inputs the main path gives it in pose 0's next step: the extend
    queue seeded with the sphere pass's t, and the shadow queue that shade
    makes from those hits."""
    cfg, sc = ren.cfg, ren.scene
    cam = camera_for_pose(0)
    ren.step(cam, 1)
    rays = tr.merge_queue(cfg, ren.state, cam.to_device(cfg, DEV))
    o, d = rays["origin"], rays["direction"]
    t_sph, sph_id = intersect_spheres(o, d, sc.sphere_center, sc.sphere_radius)
    t, tri_id = ktrav.closest_hit_packets(o, d, ren.tables, t_sph)
    t_p, id_p = plain_trav.closest_hit(o, d, sc.bvh, t_sph)
    closest = check_closest("slice extend closest", t, tri_id, t_p, id_p)
    ms = cuda_ms(lambda: ktrav.closest_hit_packets(o, d, ren.tables, t_sph), 5)
    plain_ms = cuda_ms(lambda: plain_trav.closest_hit(o, d, sc.bvh, t_sph), 1)
    # the same rays without the sphere pass's t_init: how much the spheres
    # (the ground sphere above all) prune the BVH walk
    unseeded_ms = cuda_ms(lambda: ktrav.closest_hit_packets(o, d, ren.tables),
                          5)

    is_tri = tri_id >= 0
    _, _, _, shadow = tr._shade(
        cfg, sc, ren.sky_params, ren.sun_dir, rays, t,
        torch.where(is_tri, tri_id, sph_id), is_tri, ren.state.frame)
    valid = shadow["valid"]  # connect's inputs: invalid rays get maxd 0
    maxd = torch.where(valid, shadow["max_dist"],
                       torch.zeros_like(shadow["max_dist"]))
    so, sd = shadow["origin"].contiguous(), shadow["direction"].contiguous()
    occ = ktrav.any_hit_packets(so, sd, maxd, ren.tables)
    occ_p = plain_trav.any_hit(so, sd, maxd, sc.bvh)
    anyhit = check_any("slice connect any hit", occ, occ_p)
    any_ms = cuda_ms(lambda: ktrav.any_hit_packets(so, sd, maxd, ren.tables),
                     5)
    any_plain_ms = cuda_ms(lambda: plain_trav.any_hit(so, sd, maxd, sc.bvh),
                           1)
    log(f"traverse at the slice's shapes ({o.shape[0]} rays): closest kernel "
        f"{ms:.3f} ms (without the sphere t_init {unseeded_ms:.3f} ms), plain "
        f"{plain_ms:.3f} ms; any hit ({int(valid.sum())} valid) kernel "
        f"{any_ms:.3f} ms, plain {any_plain_ms:.3f} ms")
    return closest, anyhit, ms, plain_ms


def phase4() -> float:
    """The card against the CPU at small size."""
    cfg = small_config(width=64, height=64, num_rays=16_384)
    v0, v1, v2 = terrain(n_quads=48, towers=4)
    imgs = []
    for dev in ("cuda", "cpu"):
        ren = tr.Renderer(Scene.from_triangles(v0, v1, v2), cfg, device=dev)
        ren.step(camera_for_pose(0), 6)
        imgs.append(resolve(ren.state.accum.cpu(), cfg.width, cfg.height))
        if dev == "cuda":
            counts = ren.state.accum[:, 3].sum().item()
    mad = float((imgs[0] - imgs[1]).abs().mean())
    log(f"phase 4 card vs cpu at 64x64/16384 rays/6 steps: mean |diff| "
        f"{mad:.3g} ({counts:.0f} paths on the card)")
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
    ren = tr.Renderer(scene_host, cfg, device="cuda")
    log(f"scene: {scene_host.stats['triangles']} triangles, "
        f"{ren.scene.bvh.n_nodes} nodes, {ren.tables.rows.shape[0]} fat rows, "
        f"max depth {ren.tables.max_depth}, built+uploaded in "
        f"{time.perf_counter() - t0:.1f} s")

    p1_closest, p1_any = phase1(ren.scene, ren.tables)
    acc_err, acc_ms, acc_plain_ms = phase2(cfg.num_pixels, cfg.num_rays)
    poses, launches = phase3(ren)
    sl_closest, sl_any, trav_ms, trav_plain_ms = kernels_at_slice(ren)
    phase4()

    checks = [p1_closest, p1_any, sl_closest, sl_any]
    result = {"kernels": [
        {"name": "traverse", "route": "cuda",
         "source": "tyrant_tpu_torch/csrc/traverse.cu",
         "replaces": "tyrant_tpu/ops/pallas/traverse_kernel.py:164",
         "launches": launches["traverse"],
         "max_abs_err": max(p1_closest["max_dt"], sl_closest["max_dt"]),
         "mismatches": sum(c["mismatches"] for c in checks),
         "ties": p1_closest["ties"] + sl_closest["ties"],
         "rays_checked": sum(c["rays"] for c in checks),
         "ms": trav_ms, "plain_ms": trav_plain_ms},
        {"name": "accumulate", "route": "cuda",
         "source": "tyrant_tpu_torch/csrc/accum.cu",
         "replaces": "tyrant_tpu/ops/pallas/accum_kernel.py:50",
         "launches": launches["accumulate"], "max_abs_err": acc_err,
         "ms": acc_ms, "plain_ms": acc_plain_ms}]}
    log(json.dumps({"poses": poses, "build_s": build_s}))
    log(gpu)
    log(json.dumps(result))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
