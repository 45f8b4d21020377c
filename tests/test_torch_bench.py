"""The port's bench path on the CPU: the equivalence gate
(``bench/equivalence.py``) finds agreement and reports a corrupted kernel,
and the pose harness (``bench/harness.py``) counts shadow rays as the JAX
harness's Renderer does and reports the JAX keys."""

import dataclasses

import numpy as np
import pytest
import torch

from tyrant_tpu import render as jr
from tyrant_tpu.bench import harness as jharness
from tyrant_tpu.config import small_config as j_small_config
from tyrant_tpu.scene.scene import Scene as JScene
from tyrant_tpu_torch.bench import equivalence, harness
from tyrant_tpu_torch.config import small_config
from tyrant_tpu_torch.ops.kernels import stream as kstream
from tyrant_tpu_torch.ops.kernels import traverse as ktrav
from tyrant_tpu_torch.scene.procgen import terrain
from tyrant_tpu_torch.scene.scene import Scene

N_GATE = 4096


@pytest.fixture(scope="module")
def scene():
    return Scene.from_triangles(*terrain(n_quads=32, towers=3),
                                builder="numpy")


def test_gate_passes_on_the_plain_versions(scene):
    before = (ktrav.launches, ktrav.launches_wave, kstream.launches)
    assert equivalence.check_equivalence(scene, N_GATE, device="cpu") == "ok"
    assert (ktrav.launches, ktrav.launches_wave, kstream.launches) == before


def _corrupt_first_hit(fn, dt=0.0):
    """fn with the first hit's id moved by one and its t by ``dt`` (the
    stream's tie rule forgives an id whose t agrees)."""
    def wrapped(*args, **kwargs):
        t, ids = fn(*args, **kwargs)
        t, ids = t.clone(), ids.clone()
        k = int(torch.nonzero(ids >= 0)[0])
        ids[k] += 1
        t[k] += dt
        return t, ids
    return wrapped


def _raising(*args, **kwargs):
    raise RuntimeError("stream traversal frontier overflow")


@pytest.mark.parametrize("target,want", [
    ("closest_hit_packets", "mono:closest-id mismatch on 1/4096;"
                            "wave:closest-id mismatch on 1/4096;stream:ok"),
    ("closest_hit_stream", "mono:ok;wave:ok;"
                           "stream:closest-id mismatch on 1/4096"),
    ("stream_raises", "mono:ok;wave:ok;stream:error RuntimeError: stream "
                      "traversal frontier overflow"),
])
def test_gate_reports_a_corrupted_kernel(scene, monkeypatch, target, want):
    if target == "closest_hit_packets":
        monkeypatch.setattr(ktrav, target,
                            _corrupt_first_hit(ktrav.closest_hit_packets))
    elif target == "closest_hit_stream":
        monkeypatch.setattr(kstream, target, _corrupt_first_hit(
            kstream.closest_hit_stream, dt=1.0))
    else:
        monkeypatch.setattr(kstream, "closest_hit_stream", _raising)
    assert equivalence.check_equivalence(scene, N_GATE, device="cpu") == want


def test_gate_rays_follow_bench_py(scene):
    """bench.py's recipe: default_rng(2024), half aimed into the box."""
    sd = scene.to_device("cpu")
    o, d, lo, hi = equivalence.gate_rays(sd.bvh, 1000)
    r = np.random.default_rng(2024)
    want_o = (lo + (hi - lo) * r.uniform(-0.2, 1.2, (1000, 3))).astype(
        np.float32)
    np.testing.assert_array_equal(o, want_o)
    np.testing.assert_allclose(np.linalg.norm(d, axis=1), 1.0, rtol=1e-6)


def test_run_benchmark_counts_shadow_rays_as_jax():
    """One pose on the CPU: the shadow share of the timed steps against the
    JAX Renderer's counter over the same steps, within 1%."""
    v0, v1, v2 = terrain(n_quads=16, towers=2)
    cfg = small_config(width=64, height=64, num_rays=16_384)
    res = harness.run_benchmark(
        Scene.from_triangles(v0, v1, v2, builder="numpy"), cfg,
        seconds_per_pose=1e-3, warmup_steps=1, poses=[0],
        steps_per_sample=2, max_retries=0, device="cpu")
    assert len(res) == 1 and isinstance(res[0], harness.PoseResult)
    r = res[0]
    assert r.pose == 0 and r.frames >= 2 and r.frames % 2 == 0
    assert r.min_ms <= r.avg_ms <= r.max_ms and r.outliers_dropped == 0
    share = r.shadow_rays_per_s / r.segments_per_s
    assert r.total_mrays_per_s == pytest.approx(
        (r.segments_per_s + r.shadow_rays_per_s) / 1e6)

    jren = jr.Renderer(JScene.from_triangles(v0, v1, v2, builder="numpy"),
                       j_small_config(width=64, height=64, num_rays=16_384),
                       sun_position=(0.05, 0.3), donate=False)
    cam = jharness._camera_for_pose(0)
    jren.step(cam, 1)
    c0 = int(np.asarray(jren.state.shadow_rays))
    jren.step(cam, r.frames)
    c1 = int(np.asarray(jren.state.shadow_rays))
    want = ((c1 - c0) % (1 << 32)) / (r.frames * cfg.num_rays)
    assert want > 0.05
    assert share == pytest.approx(want, rel=0.01)


def test_results_keep_the_jax_keys(tmp_path):
    fields = [f.name for f in dataclasses.fields(harness.PoseResult)]
    assert fields == [f.name for f in dataclasses.fields(jharness.PoseResult)]
    vals = dict(pose=1, frames=8, avg_ms=30.5, min_ms=29.0, max_ms=33.25,
                fps=1e3 / 30.5, segments_per_s=6.9e7,
                shadow_rays_per_s=2.1e6, total_mrays_per_s=71.1)
    ours = [harness.PoseResult(**vals), harness.PoseResult(**vals)]
    theirs = [jharness.PoseResult(**vals), jharness.PoseResult(**vals)]
    assert harness.results_to_dict(ours) == jharness.results_to_dict(theirs)
    harness.write_performance_txt(ours, str(tmp_path / "ours.txt"))
    jharness.write_performance_txt(theirs, str(tmp_path / "theirs.txt"))
    assert (tmp_path / "ours.txt").read_text() \
        == (tmp_path / "theirs.txt").read_text()
