"""The harness finds what a cell is made of by the names in
``BENCHMARK.json`` and the configuration file: a configuration, a traffic
mix, an end-to-end or per-layer metric, a scene generator
(``perfbench/scenes/<name>.py``) and a plain reference
(``perfbench/reference/<name>.py``) added as new files need no edit of a
file the harness has, and a name with no file fails in set-up, naming
the path.  The files below live in a temporary checkout."""

import hashlib
import json
import re
import shutil

import pytest

import pb_cpu
from perfbench import drive, run, terrain

NEW_METRIC = '''"""Frames the window completed (a metric added as a file)."""


def read(ctx):
    return float(ctx.window.frames)
'''

GENERATOR = '''"""The default scene on a terrain of another seed (a scene
generator added as a file); it records what it made."""

import hashlib
import json
from pathlib import Path

from perfbench.scenes import terrain_spheres


def make(scene):
    kw = terrain_spheres.make(
        dict(scene, terrain=dict(scene["terrain"], seed=8)))
    with open(Path(__file__).parents[2] / "calls.jsonl", "a") as f:
        f.write(json.dumps({"by": "generator", "v0": hashlib.sha256(
            kw["v0"].tobytes()).hexdigest()}) + "\\n")
    return kw
'''

REFERENCE = '''"""The benchmark's reference, recording the scene it was given
(a plain reference added as a file)."""

import hashlib
import json
from pathlib import Path

from perfbench.reference import pathtracer


def make_step(scene_kw, config, render, device, dtype):
    with open(Path(__file__).parents[2] / "calls.jsonl", "a") as f:
        f.write(json.dumps({"by": "reference", "v0": hashlib.sha256(
            scene_kw["v0"].tobytes()).hexdigest()}) + "\\n")
    return pathtracer.make_step(scene_kw, config, render, device, dtype)
'''


def _digest(a) -> str:
    return hashlib.sha256(a.tobytes()).hexdigest()


def add_config(checkout, name: str, generator: str | None = None,
               reference: str | None = None) -> str:
    """A tiny configuration of the main scene, naming its own generator
    and reference, with a ``poses`` cell: new files and manifest entries
    only.  Returns the cell's name."""
    cfg = json.loads((checkout / "perfbench" / "configs" /
                      "tiny_world.json").read_text())
    cfg["name"] = name
    if generator:
        cfg["scene"]["generator"] = generator
    if reference:
        cfg["reference"] = reference
    (checkout / "perfbench" / "configs" / f"{name}.json").write_text(
        json.dumps(cfg))
    manifest = json.loads((checkout / "BENCHMARK.json").read_text())
    manifest["configs"].append({"name": name, "source": "test",
                                "file": f"perfbench/configs/{name}.json",
                                "reduced": [], "why": "test"})
    manifest["workloads"].append({"name": f"{name}.poses", "config": name,
                                  "traffic": "poses", "chips": 1,
                                  "why": "test"})
    (checkout / "BENCHMARK.json").write_text(json.dumps(manifest))
    return f"{name}.poses"


@pytest.fixture
def checkout(tmp_path):
    src = pb_cpu.ROOT / "perfbench"
    dst = tmp_path / "perfbench"
    for sub in ("end_to_end", "layer_metrics", "traffic", "scenes",
                "reference"):
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


def test_a_scene_generator_and_a_reference_added_as_files_run(checkout):
    """A configuration that names a generator and a reference of its own,
    added as new files: the run is correct, the scene is the generator's
    (the terrain with seed 8, not 7), the reference was handed that same
    scene, and no file the checkout took from the harness was edited."""
    pb_cpu.pin_threads()
    (checkout / "perfbench" / "scenes" / "terrain_reseeded.py").write_text(
        GENERATOR)
    (checkout / "perfbench" / "reference" / "pathtracer_logged.py"
     ).write_text(REFERENCE)
    cell = add_config(checkout, "tiny_reseeded", "terrain_reseeded",
                      "pathtracer_logged")
    out = run.run(cell, 2_147_483_711, 1.0, False, device="cpu",
                  root=checkout)
    assert out["correct"], out["checks"]
    assert set(out["checks"]) == {"pixels_off_pct", "shadow_count_z"}
    calls = [json.loads(line) for line in
             (checkout / "calls.jsonl").read_text().splitlines()]
    n = pb_cpu.TINY["terrain"]["n_tris_target"]
    seeded = _digest(terrain.benchmark_scene(n, seed=8)[0])
    assert seeded != _digest(terrain.benchmark_scene(n, seed=7)[0])
    assert calls == [{"by": "generator", "v0": seeded},
                     {"by": "reference", "v0": seeded}]
    src = pb_cpu.ROOT / "perfbench"
    for path in (checkout / "perfbench").rglob("*"):
        twin = src / path.relative_to(checkout / "perfbench")
        if path.is_file() and twin.is_file():
            assert path.read_bytes() == twin.read_bytes(), path


@pytest.mark.parametrize("kind,name", [("scenes", "no_such_scene"),
                                       ("reference", "no_such_reference")])
def test_a_missing_module_fails_in_set_up(checkout, monkeypatch, kind,
                                          name):
    def warm_up(self):
        raise AssertionError("set-up went on past the missing module")
    monkeypatch.setattr(drive.Driver, "warm_up", warm_up)
    cell = add_config(checkout, f"tiny_{name}",
                      name if kind == "scenes" else None,
                      name if kind == "reference" else None)
    path = checkout / "perfbench" / kind / f"{name}.py"
    with pytest.raises(FileNotFoundError, match=re.escape(str(path))):
        run.run(cell, 2_147_483_712, 1.0, False, device="cpu", root=checkout)


def test_every_named_file_is_there():
    manifest = run.load_manifest()
    perf = pb_cpu.ROOT / "perfbench"
    for c in manifest["configs"]:
        assert (pb_cpu.ROOT / c["file"]).is_file()
        config = json.loads((pb_cpu.ROOT / c["file"]).read_text())
        run.scene_generator(config)
        run.reference_module(config)
    for w in manifest["workloads"]:
        assert (perf / "traffic" / f"{w['traffic']}.json").is_file()
        run.find(manifest, w["name"])
    for m in manifest["end_to_end"]:
        assert (perf / "end_to_end" / f"{m['name']}.py").is_file()
    for m in manifest["per_layer"]:
        assert (perf / "layer_metrics" / f"{m['name']}.py").is_file()
