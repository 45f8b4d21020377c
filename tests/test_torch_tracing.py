"""The port's tracer (``tyrant_tpu_torch.utils.profiling``): off, it
records nothing and leaves the step bit for bit as it was; on, the host
spans of ``Renderer.step`` and ``image`` nest by their names, the stage
markers fill a ring row a step that wraps, the per-step counters equal a
recount from the stages' outputs, the clock fit maps its pairs exactly,
and the Chrome export loads.  On the CPU the markers take the host clock.
The textured cases hold the plain shade body's ``fetch_end`` marker
and its counters of map taps, pass-throughs and GGX hits against a
recount; a fogged many-light case its ``nee_end`` marker and its
counters of medium events and lamp and delta-light picks.  The last three tests (marked ``gpu``) hold the markers and
counters of a captured step on the card against CUDA events and the
step's state, the tracer's kernels against their CPU versions, and a
captured textured step's counters (the textured shade kernels') against
a recount from the plain shade body.  This file imports
no JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_tracing.py
"""

import dataclasses
import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from tyrant_tpu_torch import render as tr
from tyrant_tpu_torch.camera import Camera
from tyrant_tpu_torch.config import VERY_FAR, small_config
from tyrant_tpu_torch.scene import files
from tyrant_tpu_torch.scene.procgen import terrain
from tyrant_tpu_torch.scene.scene import Scene
from tyrant_tpu_torch.utils import profiling

CFG = small_config(width=16, height=16, num_rays=1 << 10)
# the most a captured 2M-ray step's tail may take on the card: the copies
# into the graph's static buffers and the tracer's counters after the end
# marker (0.26 ms on an H100 80GB HBM3 at 700 W)
TAIL_MS = 0.4
STEP_NAMES = ("render.step", "render.step.reset", "render.step.eager",
              "render.step.adapt", "render.image", "render.image.resolve")


@pytest.fixture(autouse=True)
def _tracer_off():
    """One thread (the renders share the machine with other workers), and
    the tracer off again after each test."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    profiling.disable()
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scene():
    return Scene.from_triangles(*terrain(n_quads=8, towers=2),
                                builder="numpy")


def _cam(dx: float = 0.0) -> Camera:
    cam = Camera()
    cam.position = np.array([dx, -170.0, 40.0], np.float32)
    cam.vertical_angle = -0.10
    return cam


def _frames(ren, n: int, move: bool = True) -> None:
    for i in range(n):
        ren.step(_cam(float(i % 2) if move else 0.0), 1)
        ren.image(uint8=True)


def test_off_records_nothing(scene):
    profiling.enable()
    profiling.disable()
    ren = tr.Renderer(scene, CFG, device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _frames(ren, 2)
    snap = profiling.snapshot()
    assert snap["spans"] == [] and snap["steps"] == []
    names = {e.key for e in prof.key_averages()}
    # a profiler still sees the stage ranges, and none of the tracer's spans
    assert set(profiling.STAGES) <= names
    assert not names & set(STEP_NAMES)
    assert profiling.stage("cpu", 0) is profiling.OFF


def test_state_bit_for_bit_on_and_off(scene):
    cfg = dataclasses.replace(CFG, track_variance="on")
    states = []
    for on in (False, True):
        if on:
            profiling.enable()
        ren = tr.Renderer(scene, cfg, device="cpu")
        _frames(ren, 3, move=False)
        profiling.disable()
        states.append(ren.state)
    off, on = states
    for f in dataclasses.fields(tr.RenderState):
        assert torch.equal(getattr(off, f.name), getattr(on, f.name)), f.name


def _tree(snap):
    spans = snap["spans"]
    return [(s["name"], None if s["parent"] is None
             else spans[s["parent"]]["name"]) for s in spans]


def test_span_tree_of_step_and_image(scene):
    profiling.enable()
    ren = tr.Renderer(scene, CFG, device="cpu")
    ren.step(_cam(0.0), 2)
    ren.step(_cam(1.0), 1)          # a new pose: a reset
    ren.image(uint8=True)
    snap = profiling.snapshot()
    assert _tree(snap) == [
        ("render.step", None), ("render.step.eager", "render.step"),
        ("render.step", None), ("render.step.reset", "render.step"),
        ("render.step.eager", "render.step"),
        ("render.image", None), ("render.image.resolve", "render.image")]
    spans = snap["spans"]
    # the step index the host was at: 2 steps, then 1, then the image
    assert [s["step"] for s in spans] == [0, 0, 2, 2, 2, 3, 3]
    for s in spans:
        assert s["start_ns"] <= s["end_ns"]
        if s["parent"] is not None:
            p = spans[s["parent"]]
            assert p["start_ns"] <= s["start_ns"] <= s["end_ns"] \
                <= p["end_ns"]


def test_adapt_span_only_when_the_order_is_rebuilt(scene):
    cfg = dataclasses.replace(CFG, adaptive_sampling="on",
                              adaptive_interval=2)
    profiling.enable()
    ren = tr.Renderer(scene, cfg, device="cpu")
    for _ in range(3):
        ren.step(_cam(0.0), 1)
    names = [n for n, _ in _tree(profiling.snapshot())]
    assert names.count("render.step.adapt") == 1
    assert ("render.step.adapt", "render.step") in _tree(
        profiling.snapshot())


def test_counters_equal_a_recount(scene):
    """One step of ``render_step`` with the tracer on, its counters
    against the same stages run on their own from the same state."""
    ren = tr.Renderer(scene, CFG, device="cpu")
    ren.step(_cam(0.0), 2)          # carried rays in the queue
    st = ren.state
    cam = _cam(0.0).to_device(CFG, ren.device)
    rays = tr.merge_queue(CFG, st, cam)
    t, ident, is_tri = tr._intersect_scene(
        rays["origin"], rays["direction"], ren.scene, ren.tables)
    _, survive, _, shadow = tr._shade(
        CFG, ren.scene, ren.sky_params, ren.sun_dir, rays, t, ident, is_tri,
        tr._salted_frame(CFG, st.frame))
    hit = t < VERY_FAR
    lit = tr._connect(ren.scene, dict(shadow, color=torch.ones_like(
        shadow["color"])), ren.tables)
    n = CFG.num_rays
    n_in, shadow_in = int(st.n_carried), int(st.shadow_rays)

    profiling.enable()
    new = tr.render_step(st, ren.scene, cam, ren.sun_dir, cfg=CFG,
                         tables=ren.tables, sky_params=ren.sky_params)
    snap = profiling.snapshot()
    (rec,) = snap["steps"]
    c = rec["counts"]
    assert c == snap["counters"]["cpu"]
    assert c["fresh_rays"] == n - n_in > 0
    assert c["tri_hits"] == int(is_tri.sum()) > 0
    assert c["tri_hits"] + c["sphere_hits"] == int(hit.sum())
    assert c["survivors"] == int(new.n_carried) == int(survive.sum())
    assert c["roulette_kills"] == int(
        (hit & (rays["bounces"] < CFG.max_bounces) & ~survive).sum())
    assert c["shadow_slots"] == n
    assert c["shadow_valid"] == int(new.shadow_rays) - shadow_in > 0
    assert c["unoccluded"] == int((lit != 0).any(1).sum())
    assert 0 < c["unoccluded"] <= c["shadow_valid"]
    assert c["flushed"] == n - int(new.n_carried)
    assert c["sphere_kernel"] == 0  # the CPU takes the plain sphere test


@pytest.fixture(scope="module")
def textured():
    """A small textured scene: maps, cutout leaves, blend panes and GGX
    metal over the small terrain."""
    kw = files.textured_scene(*terrain(n_quads=8, towers=2), n_leaves=2048,
                              n_blend=1024, albedo_px=64, normal_px=64,
                              rough_px=32, leaf_px=32)
    return Scene.from_triangles(**kw, builder="numpy")


def _textured_recount(ren, st, cam, monkeypatch) -> dict:
    """The textured counters recounted from one step's stages run on
    their own from state ``st`` (the tracer off), shaded by the plain body
    on any device: the hit triangles whose tri_attr row names an albedo
    map, and the pass-throughs and GGX hits that the plain shade body
    handed its bounce."""
    cfg = ren.cfg
    seen = {}
    bounce = tr._shade_bounce

    def spy(*a, **k):
        seen.update(is_pass=k["is_pass"], ggx=k["ggx"])
        return bounce(*a, **k)
    monkeypatch.setattr(tr, "_shade_bounce", spy)
    rays = tr.merge_queue(cfg, st, cam)
    t, ident, is_tri = tr._intersect_scene(
        rays["origin"], rays["direction"], ren.scene, ren.tables)
    tr._shade_plain(cfg, ren.scene, ren.sky_params, ren.sun_dir, rays, t,
                    ident, is_tri, tr._salted_frame(cfg, st.frame))
    monkeypatch.undo()
    tex = ren.scene.tri_attr[torch.clamp(ident, min=0).long(), 15] >= 0
    return {"tex_hits": int((is_tri & (t < VERY_FAR) & tex).sum()),
            "alpha_pass": int(seen["is_pass"].sum()),
            "ggx_hits": int(seen["ggx"][0].sum())}


def test_textured_counters_equal_a_recount(textured, monkeypatch):
    """One step of ``render_step`` on a textured scene with the tracer on:
    ``tex_hits``, ``alpha_pass`` and ``ggx_hits`` against a recount from
    the same state, every one of them above 0, and the ``fetch_end``
    marker between the shade and connect markers."""
    cfg = dataclasses.replace(CFG, num_rays=1 << 12)
    ren = tr.Renderer(textured, cfg, device="cpu")
    ren.step(_cam(0.0), 2)          # carried rays in the queue
    st = ren.state
    cam = _cam(0.0).to_device(cfg, ren.device)
    want = _textured_recount(ren, st, cam, monkeypatch)
    profiling.enable()
    tr.render_step(st, ren.scene, cam, ren.sun_dir, cfg=cfg,
                   tables=ren.tables, sky_params=ren.sky_params)
    (rec,) = profiling.snapshot()["steps"]
    assert {k: rec["counts"][k] for k in want} == want
    assert min(want.values()) > 0, want
    assert want["alpha_pass"] < want["tex_hits"] <= rec["counts"]["tri_hits"]
    assert rec["counts"]["shade_fused"] == 0
    m = rec["marks"]
    assert m["shade"] <= m["fetch_end"] <= m["connect"]


def test_untextured_step_counts_no_texture_work(scene):
    profiling.enable()
    ren = tr.Renderer(scene, CFG, device="cpu")
    _frames(ren, 2)
    for s in profiling.snapshot()["steps"]:
        assert s["counts"]["tex_hits"] == s["counts"]["alpha_pass"] \
            == s["counts"]["ggx_hits"] == 0
        assert s["counts"]["fog_events"] == s["counts"]["tri_light_picks"] \
            == s["counts"]["delta_light_picks"] == 0
        assert s["marks"]["shade"] <= s["marks"]["fetch_end"] \
            <= s["marks"]["nee_end"] <= s["marks"]["connect"]


@pytest.fixture(scope="module")
def fog_lights(tmp_path_factory):
    """A small fogged many-light scene: 80 lamp triangles of the small
    terrain, the lights description's spheres (three emissive) and its
    point, spot and directional lights (86 lights: an alias pick), and the
    config's height fog over the terrain's z range."""
    from tyrant_tpu_torch.scene.description import load_description
    from tyrant_tpu_torch.scene.scene import DeltaLights
    v0, v1, v2 = terrain(n_quads=8, towers=2)
    refl, color = files.lamp_triangles(len(v0), 80)
    spheres = load_description(files.write_lights_description(
        tmp_path_factory.mktemp("fog_lights") / "lights.json")).scene.spheres
    sc = Scene.from_triangles(v0, v1, v2, spheres=spheres, tri_refl=refl,
                              tri_color=color, builder="numpy",
                              delta_lights=DeltaLights.from_specs(
                                  files.DELTA_LIGHTS))
    zs = np.concatenate([v0, v1, v2])[:, 2]
    cfg = dataclasses.replace(
        CFG, num_rays=1 << 12, fog="on", fog_sigma_s=0.02,
        fog_sigma_a=0.005, fog_g=0.6, fog_falloff=0.05,
        fog_z_min=float(zs.min()), fog_z_max=float(zs.max()),
        light_sampling="power")
    return sc, cfg


def test_fog_lights_counters_equal_a_recount(fog_lights, monkeypatch):
    """One step of ``render_step`` on the fogged many-light scene with the
    tracer on: ``fog_events``, ``tri_light_picks`` and
    ``delta_light_picks`` against the masks of the plain shade body
    recomputed from the same state, each above 0, and the markers in the
    order ``shade`` < ``fetch_end`` < ``nee_end`` < ``connect``."""
    scene, cfg = fog_lights
    ren = tr.Renderer(scene, cfg, device="cpu")
    sd = ren.scene
    assert sd.n_tri_lights + sd.n_delta_lights + len(sd.light_indices) > 64
    ren.step(_cam(0.0), 2)          # carried rays in the queue
    st = ren.state
    cam = _cam(0.0).to_device(cfg, ren.device)
    seen = {}
    weights = tr._shade_nee_weights

    def spy(*a, **k):
        out = weights(*a, **k)
        seen.update(nee=a[10], is_fog=k["is_fog"], is_diff=out[5],
                    is_phong=out[6])
        return out
    monkeypatch.setattr(tr, "_shade_nee_weights", spy)
    rays = tr.merge_queue(cfg, st, cam)
    t, ident, is_tri = tr._intersect_scene(
        rays["origin"], rays["direction"], sd, ren.tables)
    tr._shade_plain(cfg, sd, ren.sky_params, ren.sun_dir, rays, t, ident,
                    is_tri, tr._salted_frame(cfg, st.frame))
    monkeypatch.undo()
    pick, first = seen["nee"]["pick"], len(sd.light_indices)
    lit = (seen["is_diff"] | seen["is_phong"] | seen["is_fog"]) \
        & ~seen["nee"]["choose_sun"]
    want = {"fog_events": int(seen["is_fog"].sum()),
            "tri_light_picks": int((lit & (pick >= first) & (
                pick < first + sd.n_tri_lights)).sum()),
            "delta_light_picks": int((lit & (
                pick >= first + sd.n_tri_lights)).sum())}
    profiling.enable()
    tr.render_step(st, sd, cam, ren.sun_dir, cfg=cfg, tables=ren.tables,
                   sky_params=ren.sky_params)
    (rec,) = profiling.snapshot()["steps"]
    assert {k: rec["counts"][k] for k in want} == want
    assert min(want.values()) > 0, want
    m = rec["marks"]
    assert m["shade"] < m["fetch_end"] < m["nee_end"] < m["connect"]


def test_ring_wraps_and_counts_a_step_a_step(scene):
    profiling.enable(ring_steps=4)
    ren = tr.Renderer(scene, CFG, device="cpu")
    last = []
    for i in range(6):
        _frames(ren, 1, move=False)
        last.append(profiling.snapshot()["steps"][-1]["step"])
    assert np.diff(last).tolist() == [1] * 5
    steps = profiling.snapshot()["steps"]
    assert [s["step"] for s in steps] == list(range(last[-1] - 3,
                                                    last[-1] + 1))
    for s in steps:
        t = [s["marks"][m] for m in profiling.MARKERS]
        assert None not in t and t == sorted(t)
        assert s["counts"]["shadow_slots"] == CFG.num_rays


def test_clock_fit_maps_its_pairs_exactly():
    d0, h0 = 1_760_000_000_123_456_789, 48_213_000_000_017
    pairs = [(h0 + 2 * k + 3, d0 + k, 7 + k) for k in
             (0, 61_000_000_000, 122_000_000_000)]
    clock = profiling.fit_clock(pairs)
    assert clock["slope"] == 2.0 and clock["uncertainty_ns"] == 7 + 122e9
    for h, d, _ in pairs:
        assert profiling.to_host(clock, d) == h
    one = profiling.fit_clock(pairs[:1])
    assert profiling.to_host(one, d0 + 10) == pairs[0][0] + 10
    assert profiling.to_host(profiling.fit_clock([]), 12345) == 12345


def test_export_chrome_loads(scene, tmp_path):
    profiling.enable()
    ren = tr.Renderer(scene, CFG, device="cpu")
    _frames(ren, 2)
    path = profiling.export_chrome(str(tmp_path / "t" / "trace.json"))
    with open(path) as f:
        ev = json.load(f)["traceEvents"]
    names = {e["name"] for e in ev if e["ph"] == "X"}
    assert set(profiling.STAGES) | {"image", "render.step",
                                    "render.image"} <= names
    assert sum(e["ph"] == "C" for e in ev) == 2
    stages = [e for e in ev if e.get("cat") == "stage"]
    assert all(e["dur"] >= 0 for e in stages)


def test_spans_and_stages_are_profiler_ranges(scene):
    profiling.enable()
    ren = tr.Renderer(scene, CFG, device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _frames(ren, 2)
    names = {e.key for e in prof.key_averages()}
    assert set(profiling.STAGES) <= names
    assert {"render.step", "render.step.reset", "render.step.eager",
            "render.image", "render.image.resolve"} <= names


@pytest.mark.gpu
def test_captured_markers_on_the_card():
    """A captured 2M-ray step: every replay writes its markers in order,
    the six stages and the tail after the end marker (the copies into the
    graph's static buffers and the counters, to the next step's raygen
    marker) sum to within 2% of CUDA-event time around the replays, the
    tail is at most TAIL_MS a step (so the stages cover the rest of the
    step's device time), the markers start after the replay's host span
    began (within the clock's uncertainty), a profiler names each marker
    kernel, and each replayed step's counters equal what its state says
    (``chip_smoke.check_counters``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the marker kernel has no CPU mode")
    import chip_smoke
    dev = torch.device("cuda")
    cfg = small_config(width=1920, height=1080, num_rays=1 << 21)
    sc = Scene.from_triangles(*terrain(n_quads=64, towers=4),
                              builder="numpy")
    profiling.enable()
    ren = tr.Renderer(sc, cfg, device=dev)
    assert ren.captured
    ren.step(_cam(0.0), 3)
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    reps = 12
    a.record()
    ren.step(_cam(0.0), reps)
    b.record()
    torch.cuda.synchronize()
    snap = profiling.snapshot()
    steps = snap["steps"][-reps:]
    assert np.diff([s["step"] for s in steps]).tolist() == [1] * (reps - 1)
    stage_ns = tail_ns = 0
    for s, nxt in zip(steps, steps[1:]):
        tail_ns += nxt["marks"]["raygen"] - s["marks"]["end"]
    for s in steps:
        t = [s["marks"][m] for m in profiling.MARKERS[:profiling.END + 1]]
        assert None not in t and t == sorted(t), s
        stage_ns += t[-1] - t[0]
    # the last step's tail taken as the mean of the others'
    tail_ns *= reps / (reps - 1)
    ms = a.elapsed_time(b)
    print(f"{reps} replays: {ms:.3f} ms by CUDA events, six stages "
          f"{stage_ns / 1e6:.3f} ms, tail {tail_ns / 1e6:.3f} ms")
    assert 0 < tail_ns <= TAIL_MS * 1e6 * reps, (tail_ns / 1e6, reps)
    assert abs((stage_ns + tail_ns) / 1e6 - ms) <= 0.02 * ms, \
        (stage_ns / 1e6, tail_ns / 1e6, ms)
    clock = snap["clock"][str(steps[0]["device"])]
    replays = {s["step"]: s for s in snap["spans"]
               if s["name"] == "render.step.replay"}
    for s in steps:
        assert s["marks"]["raygen"] >= replays[s["step"]]["start_ns"] \
            - clock["uncertainty_ns"]
    assert clock["uncertainty_ns"] < 20_000
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        ren.step(_cam(0.0), 1)
        torch.cuda.synchronize()
    kernels = {e.key for e in prof.key_averages()}
    for k in range(profiling.END + 1):
        assert any(f"trace_marker<{k}>" in n for n in kernels), kernels
    assert "render.step.replay" in kernels and "render.step.camera" in kernels

    # the counters, a step at a time: the graph's count kernel on the ring
    # the renewed tracer reads on
    carried0 = int(ren.state.n_carried)
    shadow0 = int(ren.state.shadow_rays)
    profiling.enable()
    seen = []
    for _ in range(4):
        st = ren.step(_cam(0.0), 1)
        seen.append((int(st.n_carried), int(st.shadow_rays)))
    chip_smoke.check_counters(profiling.snapshot(), cfg.num_rays, carried0,
                              shadow0, seen, spheres=True)


@pytest.mark.gpu
def test_trace_kernels_against_plain_on_the_card():
    """``trace_count`` and ``trace_marker<K>`` against the tracer's CPU
    branches on the same values, on a 16-step ring that wraps
    (``chip_smoke.trace_ring_check``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the tracer's kernels have no CPU "
                    "mode")
    import chip_smoke
    chip_smoke.trace_ring_check(steps=40, slots=16)


@pytest.mark.gpu
def test_textured_counters_on_the_card(textured, monkeypatch):
    """One captured 2M-ray step on a textured scene on the card: its
    ``tex_hits``, ``alpha_pass`` and ``ggx_hits`` against a recount from
    the step's stages run eagerly on the state it started from, with the
    camera buffer the graph reads, and its ``fetch_end`` marker between
    the shade and connect markers."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the marker kernel has no CPU mode")
    dev = torch.device("cuda")
    cfg = small_config(width=1920, height=1080, num_rays=1 << 21)
    profiling.enable()
    ren = tr.Renderer(textured, cfg, device=dev)
    assert ren.captured
    ren.step(_cam(0.0), 3)
    profiling.disable()             # the recount records nothing
    st = tr.RenderState(**{f.name: getattr(ren.state, f.name).clone()
                           for f in dataclasses.fields(tr.RenderState)})
    want = _textured_recount(ren, st, ren._cam, monkeypatch)
    ren.step(_cam(0.0), 1)          # one replay of the captured step
    rec = profiling.snapshot()["steps"][-1]
    print("textured counters", want, rec["counts"])
    assert {k: rec["counts"][k] for k in want} == want
    assert min(want.values()) > 0, want
    m = rec["marks"]
    assert m["shade"] <= m["fetch_end"] <= m["connect"]
