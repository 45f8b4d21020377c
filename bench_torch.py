"""The benchmark of the PyTorch/CUDA port, the counterpart of ``bench.py``.

Prints, as the last line of standard output, ONE JSON object with
bench.py's keys:

  {"metric": "total_ray_throughput_1080p_1m_tri", "value": N,
   "unit": "Mrays/s", "vs_baseline": N / BASELINE_MRAYS,
   "equivalence": "ok", "detail": {...}}

Every earlier line goes to standard error, prefixed "# ": the card's name
and power limit (``nvidia-smi``), each pose, the scenes' statistics.

The configuration is bench.py's, the reference's PERFORMANCE_TEST: 1920x1080,
a 2,097,152-ray queue, 5 bounces, the three fixed poses of
``bench/poses.py``, 4 warm-up steps a pose.  The step runs as the
``Renderer``'s users get it (``fuse_step_chains`` at its default: on the
card, a captured CUDA graph).  Two scenes are timed:

  * the metric of record, always the ~1M-triangle procedural terrain
    (``benchmark_scene(1_048_576)``, 1,048,496 triangles) built by the
    native builder;
  * the dragon row: ``benchmark_scene(65_536)``, labelled by
    ``dragon_source`` "procgen_fallback_65k" as bench.py labels it when
    the reference project's ``dragon.ply`` is absent.  No mesh file is
    read: every scene is made here from procgen.

Before the timing, the equivalence gate (``bench/equivalence.py``: the
mono, wave and stream traversal kernels against the plain walk on the
dragon scene) runs in this process; its result goes into "equivalence"
unchanged.  When it is not "ok" the line is still printed and the script
exits 1.

Unlike bench.py, nothing here hides a failure: a terrain build without the
native builder, a kernel that does not build or launch, or any other
exception ends the run non-zero with no JSON line.  Not ported, as TPU
workarounds: the worker probe (``_wait_for_tpu``), the gate's subprocess
with its 900 s timeout and its retry, the flap-sample drop
(``flap_samples_dropped`` is always 0), the 65,536-triangle terrain when
the native builder is missing, and the dragon number reported under
another metric name when the terrain bench raises.  bench.py's search for
``dragon.ply`` outside the repository is not ported either.

    python3 bench_torch.py                     # the line
    python3 bench_torch.py --equivalence-only  # EQUIVALENCE::<result>
    python3 bench_torch.py --scene terrain     # one scene's numbers

It writes no file.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from tyrant_tpu_torch.bench.equivalence import check_equivalence  # noqa: E402
from tyrant_tpu_torch.bench.harness import (results_to_dict,  # noqa: E402
                                            run_benchmark)
from tyrant_tpu_torch.config import RenderConfig  # noqa: E402
from tyrant_tpu_torch.scene.procgen import benchmark_scene  # noqa: E402
from tyrant_tpu_torch.scene.scene import Scene  # noqa: E402

BASELINE_MRAYS = 100.0
METRIC = "total_ray_throughput_1080p_1m_tri"
TERRAIN_TRIS = 1_048_576  # benchmark_scene's target: 1,048,496 triangles
DRAGON_TRIS = 65_536
DRAGON_SOURCE = "procgen_fallback_65k"
GATE_RAYS = 65_536


def log(msg: str) -> None:
    print("# " + msg, file=sys.stderr, flush=True)


def gpu_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def bench_config() -> RenderConfig:
    """1080p, a 2M-ray queue, 5 bounces: the reference harness's exact
    configuration (bench.py:151-153; ``use_packet_kernel`` is a TPU
    selector the port accepts and ignores)."""
    return RenderConfig(width=1920, height=1080, num_rays=2 * 1_048_576,
                        max_bounces=5, use_packet_kernel="on")


def bench_scene(scene, seconds_per_pose: float, device="cuda",
                cfg: RenderConfig | None = None):
    """The pose harness on ``scene``: ``(results_to_dict(...), cfg)``,
    with each pose's line logged."""
    cfg = bench_config() if cfg is None else cfg
    results = run_benchmark(scene, cfg, seconds_per_pose=seconds_per_pose,
                            warmup_steps=4, device=device)
    d = results_to_dict(results)
    for r in d["poses"]:
        retry = f" [{r['retries']} retries]" if r["retries"] else ""
        log(f"  pose {r['pose']}: {r['avg_ms']:.2f} ms "
            f"({r['fps']:.1f} FPS) {r['total_mrays_per_s']:.1f} Mrays/s "
            f"spread {r['spread_pct']}%{retry}")
    return d, cfg


def dragon_scene() -> Scene:
    """The dragon row's scene (and the gate's): the 65,536-triangle
    procedural terrain that stands in for the reference's dragon."""
    return Scene.from_triangles(*benchmark_scene(DRAGON_TRIS))


def terrain_scene() -> Scene:
    """The metric of record's scene, built by the native builder: raises
    when it cannot be built."""
    return Scene.from_triangles(*benchmark_scene(TERRAIN_TRIS),
                                builder="native")


def equivalence_only(device="cuda") -> str:
    """The gate alone, on the dragon row's scene."""
    return check_equivalence(dragon_scene(), GATE_RAYS, device=device)


def result_line(terrain: dict, dragon: dict, equivalence: str,
                triangles: int, cfg: RenderConfig) -> dict:
    """bench.py's line (bench.py:300-326) from two ``bench_scene`` dicts."""
    value = terrain["total_mrays_per_s"]
    return {
        "metric": METRIC,
        "value": round(value, 2),
        "unit": "Mrays/s",
        "vs_baseline": round(value / BASELINE_MRAYS, 3),
        "equivalence": equivalence,
        "detail": {
            "avg_frame_ms": round(terrain["avg_frame_ms"], 2),
            "avg_fps": round(terrain["avg_fps"], 2),
            "segments_per_s": round(terrain["segments_per_s"] / 1e6, 2),
            "triangles": triangles,
            "wavefront": cfg.num_rays,
            "dragon_mrays_per_s": round(dragon["total_mrays_per_s"], 2),
            "dragon_avg_frame_ms": round(dragon["avg_frame_ms"], 2),
            "dragon_source": DRAGON_SOURCE,
            "pose_ms": [round(r["avg_ms"], 1) for r in terrain["poses"]],
            "pose_spread_pct": [r["spread_pct"] for r in terrain["poses"]],
            "flap_samples_dropped": sum(
                r["outliers_dropped"]
                for r in terrain["poses"] + dragon["poses"]),
        },
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--equivalence-only", action="store_true",
                    help="run the gate alone; print EQUIVALENCE::<result>")
    ap.add_argument("--scene", choices=("dragon", "terrain"),
                    help="time one scene; print its numbers as JSON")
    args = ap.parse_args(argv)

    if args.equivalence_only:
        res = equivalence_only()
        print("EQUIVALENCE::" + res)
        return 0 if res == "ok" else 1

    log(gpu_line())
    if args.scene:
        t0 = time.time()
        scene = dragon_scene() if args.scene == "dragon" \
            else terrain_scene()
        log(f"{args.scene} scene: {scene.stats} "
            f"({time.time() - t0:.1f}s build)")
        d, _ = bench_scene(scene, seconds_per_pose=6.0)
        print(json.dumps({"scene": args.scene,
                          **{k: v for k, v in d.items() if k != "poses"}}))
        return 0

    t0 = time.time()
    dragon = dragon_scene()
    log("equivalence gate (the traversal kernels against the plain "
        "walk)...")
    equivalence = check_equivalence(dragon, GATE_RAYS)
    log(f"equivalence: {equivalence}")
    log(f"dragon scene ({DRAGON_SOURCE}): {dragon.stats} "
        f"({time.time() - t0:.1f}s)")
    d_dragon, _ = bench_scene(dragon, seconds_per_pose=6.0)
    del dragon

    t0 = time.time()
    terrain = terrain_scene()
    log(f"terrain scene: {terrain.stats} ({time.time() - t0:.1f}s build)")
    d_terr, cfg = bench_scene(terrain, seconds_per_pose=6.0)
    print(json.dumps(result_line(d_terr, d_dragon, equivalence,
                                 terrain.stats["triangles"], cfg)))
    return 0 if equivalence == "ok" else 1


if __name__ == "__main__":
    sys.exit(main())
