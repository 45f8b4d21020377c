"""The readers of the program's tracer on a synthetic snapshot: each picks
the records of the tracer's pass by its window's host-clock interval and
returns the number it should, and returns None without a snapshot (a
program without the tracer, or a reader called outside a run) or with
nothing in the window.  Then the pass itself, at the CPU tests' tiny size,
in each cell whose readers read it."""

import json

import pytest

import pb_cpu
from perfbench import run, tracer
from perfbench.drive import Mix
from perfbench.run import Context, reader

MARKERS = ("raygen", "extend", "shade", "connect", "sort", "accumulate",
           "end", "image", "image_end")
# ms from the raygen marker: raygen 0.1, extend 0.7, shade 16.2, connect
# 0.8, sort 3.0, accumulate 0.2; the resolve 0.3 ms after a 0.1 ms pause
OFFSETS_MS = (0.0, 0.1, 0.8, 17.0, 17.8, 20.8, 21.0, 21.1, 21.4)
NEW = ("extend_graph_ms.poses", "shade_graph_ms.poses",
       "connect_graph_ms.poses", "sort_graph_ms.poses",
       "connect_valid_pct.poses", "replay_host_ms.preset",
       "device_gap_ms.preset", "device_gap_ms.fly")
T0 = 100.0  # the window's start, s on the host clock
FRAME_MS = 25.0  # raygen to raygen


def _step(k: int, valid: int) -> dict:
    t = (T0 + 0.001) * 1e9 + k * FRAME_MS * 1e6
    return {"device": "cuda:0", "step": k,
            "marks": {m: round(t + o * 1e6) for m, o in zip(MARKERS,
                                                            OFFSETS_MS)},
            "counts": {"shadow_slots": 1000, "shadow_valid": valid}}


def snapshot() -> dict:
    """Steps 0-3 in the window (the first starts 1 ms into it), steps -1
    and 4 outside it with 0 and 1000 valid shadow rays; a replay span a
    step, 0.2 ms long, and one outside the window."""
    steps = [_step(k, {-1: 0, 4: 1000}.get(k, 250 + k))
             for k in range(-1, 5)]
    spans = [{"name": "render.step.replay",
              "start_ns": s["marks"]["raygen"] - 300_000,
              "end_ns": s["marks"]["raygen"] - 100_000, "parent": None,
              "step": s["step"]} for s in steps]
    return {"spans": spans, "steps": steps, "counters": {},
            "clock": {"cuda:0": {"uncertainty_ns": 4_000}},
            "window": {"t_start": T0, "seconds": 0.1}}


def _ctx(snap=None) -> Context:
    ctx = Context(render={"num_rays": 1000})
    ctx.tracer = snap
    return ctx


def test_readers_on_a_synthetic_snapshot():
    ctx = _ctx(snapshot())
    got = {name: reader("layer_metrics", name)(ctx) for name in NEW}
    assert got["extend_graph_ms.poses"] == pytest.approx(0.7)
    assert got["shade_graph_ms.poses"] == pytest.approx(16.2)
    assert got["connect_graph_ms.poses"] == pytest.approx(0.8)
    assert got["sort_graph_ms.poses"] == pytest.approx(3.0)
    # 250 + 251 + 252 + 253 valid of 4 x 1000 slots
    assert got["connect_valid_pct.poses"] == pytest.approx(25.15)
    assert got["replay_host_ms.preset"] == pytest.approx(0.2)
    # each step's raygen 25 ms after the last one's, which ended 21.4 ms in
    assert got["device_gap_ms.preset"] == pytest.approx(3.6)
    assert got["device_gap_ms.fly"] == pytest.approx(3.6)


def test_readers_without_a_snapshot_return_none():
    for snap in (None, {"spans": [], "steps": [], "counters": {},
                        "clock": {}, "window": {"t_start": T0,
                                                "seconds": 0.1}}):
        ctx = _ctx(snap)
        for name in NEW:
            assert reader("layer_metrics", name)(ctx) is None, name
    snap = snapshot()
    snap["window"] = {"t_start": T0 + 60.0, "seconds": 1.0}  # nothing in it
    ctx = _ctx(snap)
    for name in NEW:
        assert reader("layer_metrics", name)(ctx) is None, name
    ctx = Context(render={"num_rays": 1000})   # read outside a run
    for name in NEW:
        assert reader("layer_metrics", name)(ctx) is None, name
    assert ctx.tracer is None


def test_launch_check():
    snap = snapshot()
    got = tracer.launch_check(snap)
    assert got == {"steps": 6, "early": 0, "least_margin_us": 300.0,
                   "uncertainty_us": 4.0}
    snap["steps"][2]["marks"]["raygen"] -= 400_000   # before its launch
    assert tracer.launch_check(snap)["early"] == 1
    assert tracer.launch_check(None) is None


@pytest.mark.parametrize("cell", pb_cpu.CELLS)
def test_the_pass_at_a_tiny_size(cell):
    """The tracer's pass on the CPU, 0.5 s of the cell's traffic at the
    tiny size: its window holds steps, and the cell's new readers give a
    number (the launch span ``render.step.replay`` exists only on a card,
    where the step is captured)."""
    pb_cpu.pin_threads()
    manifest = run.load_manifest()
    found, conf = run.find(manifest, cell)
    config = json.loads((pb_cpu.ROOT / conf["file"]).read_text())
    mix = Mix.load(found["traffic"], pb_cpu.ROOT / "perfbench" / "traffic")
    snap = tracer.traced_pass(run.build, run.camera_factory, config,
                              2_147_483_901, "cpu", pb_cpu.TINY, mix, 0.5)
    ctx = _ctx(snap)
    assert tracer.window_steps(ctx)
    for m in run.metrics_of(manifest, "per_layer", cell):
        if m["name"] not in NEW:
            continue
        got = reader("layer_metrics", m["name"])(ctx)
        if m["name"] == "replay_host_ms.preset":
            assert got is None
        else:
            assert got is not None and got > 0, m["name"]
    assert tracer.launch_check(snap)["early"] == 0


def test_the_pass_in_a_process_of_its_own():
    """The pass as a traced run has it made, in a child process (0.5 s
    unread, 0.5 s read): the snapshot comes back whole."""
    snap = tracer.pass_in_child("perftest_1m.poses", 2_147_483_901, 0.5,
                                "cpu", pb_cpu.TINY, pb_cpu.ROOT)
    ctx = _ctx(snap)
    assert snap["window"]["seconds"] >= 0.5 and tracer.window_steps(ctx)
    assert 0 < reader("layer_metrics", "connect_valid_pct.poses")(ctx) < 100
    # the unread half's steps fall before the window
    assert snap["steps"][0]["marks"]["raygen"] \
        < snap["window"]["t_start"] * 1e9


def test_the_pass_takes_the_arguments_of_the_run(tmp_path, monkeypatch):
    """A reader called from a ``run`` of a ``run.py`` has the pass made
    once, with that run's arguments; the other readers reuse its
    snapshot."""
    import importlib.util
    calls = []
    monkeypatch.setattr(tracer, "pass_in_child",
                        lambda *a: calls.append(a) or snapshot())
    (tmp_path / "run.py").write_text(
        "def run(workload, seed, seconds, trace, device='cpu', tiny=None,"
        " root='.', readers=()):\n"
        "    ctx = Context()\n"
        "    return [read(ctx) for read in readers]\n")
    spec = importlib.util.spec_from_file_location("fake_run",
                                                  tmp_path / "run.py")
    mod = importlib.util.module_from_spec(spec)
    mod.Context = type("Context", (), {})
    spec.loader.exec_module(mod)
    got = mod.run("cell", 2_147_483_901, 51.0, True, tiny={"t": 1},
                  root=tmp_path,
                  readers=[reader("layer_metrics", name) for name in NEW])
    assert calls == [("cell", 2_147_483_901, 51.0, "cpu", {"t": 1},
                      tmp_path)]
    assert got[NEW.index("shade_graph_ms.poses")] == pytest.approx(16.2)
