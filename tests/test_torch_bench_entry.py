"""``bench_torch.py``, the port's counterpart of ``bench.py``, on the CPU:
``bench_scene`` at a small size with the JAX harness's keys, the result
line with exactly bench.py's keys, the gate's ``--equivalence-only`` on
the plain versions, no fallback when the native builder is missing, the
line printed and exit 1 when the gate fails, and no import of JAX or the
JAX package."""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import bench_torch
from tyrant_tpu.bench import harness as jharness
from tyrant_tpu_torch.config import small_config
from tyrant_tpu_torch.native import bvh_native
from tyrant_tpu_torch.scene import scene as scene_mod
from tyrant_tpu_torch.scene.procgen import benchmark_scene
from tyrant_tpu_torch.scene.scene import Scene

_ROOT = Path(__file__).resolve().parents[1]

# bench.py:300-326, the line's keys in order
LINE_KEYS = ["metric", "value", "unit", "vs_baseline", "equivalence",
             "detail"]
DETAIL_KEYS = ["avg_frame_ms", "avg_fps", "segments_per_s", "triangles",
               "wavefront", "dragon_mrays_per_s", "dragon_avg_frame_ms",
               "dragon_source", "pose_ms", "pose_spread_pct",
               "flap_samples_dropped"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One PyTorch thread: beside the other test workers the default of a
    thread a core oversubscribes the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def small_bench():
    """bench_scene on a 2,000-triangle terrain at 64x48 and 4,096 rays."""
    scene = Scene.from_triangles(*benchmark_scene(2_000), builder="numpy")
    cfg = small_config(width=64, height=48, num_rays=4096)
    return bench_torch.bench_scene(scene, seconds_per_pose=0.05,
                                   device="cpu", cfg=cfg)


def _jax_keys():
    vals = dict(pose=0, frames=4, avg_ms=1.0, min_ms=1.0, max_ms=1.0,
                fps=1e3, segments_per_s=1.0, shadow_rays_per_s=1.0,
                total_mrays_per_s=1.0)
    d = jharness.results_to_dict([jharness.PoseResult(**vals)])
    return sorted(d), sorted(d["poses"][0])


def test_bench_scene_small_on_the_cpu(small_bench, capsys):
    d, cfg = small_bench
    keys, pose_keys = _jax_keys()
    assert sorted(d) == keys
    assert cfg.num_rays == 4096 and cfg.width == 64
    assert [r["pose"] for r in d["poses"]] == [0, 1, 2]
    for r in d["poses"]:
        assert sorted(r) == pose_keys
        assert r["frames"] >= 4 and r["outliers_dropped"] == 0
        for k in ("avg_ms", "min_ms", "max_ms", "fps", "total_mrays_per_s"):
            assert np.isfinite(r[k]) and r[k] > 0, k
    for k in ("avg_frame_ms", "avg_fps", "total_mrays_per_s",
              "segments_per_s"):
        assert np.isfinite(d[k]) and d[k] > 0, k


def test_bench_config_is_bench_py_s():
    cfg = bench_torch.bench_config()
    assert (cfg.width, cfg.height, cfg.num_rays, cfg.max_bounces) == \
        (1920, 1080, 2_097_152, 5)
    assert cfg.fuse_step_chains == "auto"  # captured on the card
    assert bench_torch.BASELINE_MRAYS == 100.0


def test_line_has_bench_py_s_keys(small_bench):
    d, cfg = small_bench
    line = bench_torch.result_line(d, d, "ok", 2066, cfg)
    assert list(line) == LINE_KEYS
    assert list(line["detail"]) == DETAIL_KEYS
    assert line["metric"] == "total_ray_throughput_1080p_1m_tri"
    assert line["unit"] == "Mrays/s" and line["equivalence"] == "ok"
    assert line["value"] == round(d["total_mrays_per_s"], 2)
    assert line["vs_baseline"] == round(d["total_mrays_per_s"] / 100.0, 3)
    det = line["detail"]
    assert det["wavefront"] == 4096 and det["triangles"] == 2066
    assert det["flap_samples_dropped"] == 0
    assert len(det["pose_ms"]) == 3 and len(det["pose_spread_pct"]) == 3
    json.loads(json.dumps(line))


def test_equivalence_only_on_the_plain_versions(monkeypatch):
    monkeypatch.setattr(bench_torch, "DRAGON_TRIS", 2_000)
    monkeypatch.setattr(bench_torch, "GATE_RAYS", 4096)
    assert bench_torch.equivalence_only("cpu") == "ok"


@pytest.mark.parametrize("result,rc", [("ok", 0), ("mono:anyhit mismatch "
                                                   "on 1/4096", 1)])
def test_equivalence_only_prints_the_result(monkeypatch, capsys, result,
                                            rc):
    monkeypatch.setattr(bench_torch, "equivalence_only", lambda: result)
    assert bench_torch.main(["--equivalence-only"]) == rc
    assert capsys.readouterr().out.splitlines()[-1] == \
        "EQUIVALENCE::" + result


def _raise(*args, **kwargs):
    raise RuntimeError("the native builder did not build")


def test_missing_native_builder_raises(monkeypatch):
    monkeypatch.setattr(bench_torch, "TERRAIN_TRIS", 2_000)
    monkeypatch.setattr(bvh_native, "build_bvh", _raise)
    with pytest.raises(RuntimeError, match="native builder"):
        bench_torch.terrain_scene()


def _fake_run(monkeypatch, small_bench, equivalence="ok"):
    """main()'s flow on the CPU: the card's line, the gate and the pose
    harness replaced, the scenes small."""
    d, cfg = small_bench
    dragon = Scene.from_triangles(*benchmark_scene(2_000), builder="numpy")
    monkeypatch.setattr(bench_torch, "gpu_line", lambda: "no card")
    monkeypatch.setattr(bench_torch, "dragon_scene", lambda: dragon)
    monkeypatch.setattr(bench_torch, "check_equivalence",
                        lambda scene, n_rays: equivalence)
    monkeypatch.setattr(bench_torch, "bench_scene",
                        lambda scene, seconds_per_pose: (d, cfg))


def _no_numpy_build(*args, **kwargs):
    raise AssertionError("the numpy builder was called")


def test_main_has_no_fallback_terrain(monkeypatch, capsys, small_bench):
    """With the native builder missing the run raises before any line: no
    65,536-triangle terrain by the numpy builder, no dragon number under
    another name (the real ``terrain_scene``, 1M triangles made)."""
    _fake_run(monkeypatch, small_bench)
    monkeypatch.setattr(bvh_native, "build_bvh", _raise)
    monkeypatch.setattr(scene_mod, "build_bvh", _no_numpy_build)
    with pytest.raises(RuntimeError):
        bench_torch.main([])
    out = capsys.readouterr()
    assert out.out == ""
    assert "# no card" in out.err.splitlines()


@pytest.mark.parametrize("equivalence,rc", [
    ("ok", 0), ("mono:ok;wave:closest-id mismatch on 3/65536;stream:ok", 1)])
def test_main_prints_the_line(monkeypatch, capsys, small_bench, equivalence,
                              rc):
    _fake_run(monkeypatch, small_bench, equivalence)
    monkeypatch.setattr(bench_torch, "TERRAIN_TRIS", 2_000)
    assert bench_torch.main([]) == rc
    out = capsys.readouterr()
    lines = out.out.splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert list(line) == LINE_KEYS and line["equivalence"] == equivalence
    assert line["detail"]["triangles"] == 2066
    assert line["detail"]["dragon_source"] == "procgen_fallback_65k"
    assert all(ln.startswith("# ") for ln in out.err.splitlines())


def test_dragon_row_is_procgen_and_reads_no_file(monkeypatch):
    """The dragon row (and the gate's scene) is benchmark_scene's terrain,
    made in memory: no mesh file is looked for."""
    monkeypatch.setattr(bench_torch, "DRAGON_TRIS", 2_000)
    monkeypatch.setattr(Scene, "load", _raise)
    monkeypatch.setattr(bench_torch.os.path, "exists", _raise)
    sc = bench_torch.dragon_scene()
    assert sc.stats["triangles"] == 2066
    v0, _, _ = benchmark_scene(2_000)
    assert v0.shape[0] == 2066


def test_bench_torch_imports_no_jax():
    code = ("import sys\nimport bench_torch\n"
            "bad = sorted(m for m in sys.modules if m in ('jax', "
            "'tyrant_tpu') or m.startswith(('jax.', 'tyrant_tpu.')))\n"
            "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=_ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
