"""The harness finds a configuration, a traffic mix and a metric added as
files, by the names in ``BENCHMARK.json``: a new cell needs no edit of
the harness.  The files below live in a temporary checkout."""

import json
import shutil

import pytest

import pb_cpu
from perfbench import run

NEW_METRIC = '''"""Frames the window completed (a metric added as a file)."""


def read(ctx):
    return float(ctx.window.frames)
'''


@pytest.fixture
def checkout(tmp_path):
    src = pb_cpu.ROOT / "perfbench"
    dst = tmp_path / "perfbench"
    for sub in ("end_to_end", "layer_metrics", "traffic"):
        shutil.copytree(src / sub, dst / sub)
    shutil.copy(src / "limits.json", dst / "limits.json")
    (dst / "configs").mkdir()
    cfg = json.loads((src / "configs" / "perftest_1m.json").read_text())
    cfg.update(name="tiny_world")
    cfg["render"].update(pb_cpu.TINY["render"])
    cfg["scene"]["terrain"].update(pb_cpu.TINY["terrain"])
    (dst / "configs" / "tiny_world.json").write_text(json.dumps(cfg))
    orbit = json.loads((src / "traffic" / "fly.json").read_text())
    orbit["segments"][0]["flight"].update(look_dx=-3.0, lap_frames=10)
    (dst / "traffic" / "orbit.json").write_text(json.dumps(orbit))
    still = json.loads((src / "traffic" / "poses.json").read_text())
    still.update(display=True, segments=[dict(still["segments"][1],
                                              share=1.0)])
    (dst / "traffic" / "still.json").write_text(json.dumps(still))
    (dst / "end_to_end" / "frames_done.py").write_text(NEW_METRIC)
    (dst / "layer_metrics" / "frames_seen.fly.py").write_text(NEW_METRIC)
    manifest = json.loads((pb_cpu.ROOT / "BENCHMARK.json").read_text())
    manifest["configs"].append({"name": "tiny_world", "source": "test",
                                "file": "perfbench/configs/tiny_world.json",
                                "reduced": [], "why": "test"})
    manifest["workloads"].append({"name": "tiny_world.orbit",
                                  "config": "tiny_world", "traffic": "orbit",
                                  "chips": 1, "why": "test"})
    manifest["workloads"].append({"name": "tiny_world.still",
                                  "config": "tiny_world", "traffic": "still",
                                  "chips": 1, "why": "test"})
    manifest["end_to_end"].append({
        "name": "frames_done", "unit": "frames", "better": "higher",
        "bound": 0.25, "source": "host_clock",
        "workloads": ["tiny_world.orbit"]})
    for m in manifest["end_to_end"]:
        if m["name"] in ("fps", "frame_ms_p95"):
            m["workloads"] += ["tiny_world.orbit", "tiny_world.still"]
    manifest["per_layer"].append({
        "name": "frames_seen.fly", "unit": "frames", "better": "higher",
        "source": "host_clock", "layer": "test", "moves": "fps",
        "workloads": ["tiny_world.orbit"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(manifest))
    return tmp_path


def test_a_cell_added_as_files_runs(checkout):
    pb_cpu.pin_threads()
    out = run.run("tiny_world.orbit", 12_345, 1.0, False, device="cpu",
                  root=checkout)
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == {"frames_done", "fps", "frame_ms_p95",
                                   "setup_s"}
    assert out["metrics"]["frames_done"]["value"] == out["attempted"]


def test_a_still_displaying_mix_added_as_a_file_runs(checkout):
    """A camera that stays put and a frame displayed every step: the
    window's frames accumulate, and the check follows one more frame from
    the window's state, its display resolve with it."""
    pb_cpu.pin_threads()
    out = run.run("tiny_world.still", 12_346, 1.0, False, device="cpu",
                  root=checkout)
    assert out["correct"], out["checks"]
    assert set(out["checks"]) == {"pixels_off_pct", "shadow_count_z",
                                  "display_off_pct"}
    assert set(out["metrics"]) == {"fps", "frame_ms_p95", "setup_s"}


def test_a_broken_display_of_a_still_mix_is_not_correct(checkout,
                                                        monkeypatch):
    from perfbench import faults
    pb_cpu.pin_threads()
    faults.gamma(monkeypatch)
    out = run.run("tiny_world.still", 12_346, 1.0, False, device="cpu",
                  root=checkout)
    assert not out["correct"], out["checks"]


def test_a_per_layer_metric_added_as_a_file_is_found(checkout):
    manifest = json.loads((checkout / "BENCHMARK.json").read_text())
    names = [m["name"] for m in run.metrics_of(manifest, "per_layer",
                                               "tiny_world.orbit")]
    assert names == ["frames_seen.fly"]

    class Ctx:
        class window:
            frames = 7
    read = run.reader("layer_metrics", "frames_seen.fly",
                      checkout / "perfbench")
    assert read(Ctx) == 7.0


def test_every_named_file_is_there():
    manifest = run.load_manifest()
    perf = pb_cpu.ROOT / "perfbench"
    for c in manifest["configs"]:
        assert (pb_cpu.ROOT / c["file"]).is_file()
    for w in manifest["workloads"]:
        assert (perf / "traffic" / f"{w['traffic']}.json").is_file()
        run.find(manifest, w["name"])
    for m in manifest["end_to_end"]:
        assert (perf / "end_to_end" / f"{m['name']}.py").is_file()
    for m in manifest["per_layer"]:
        assert (perf / "layer_metrics" / f"{m['name']}.py").is_file()
