"""Which shade calls the shade kernels take (``kshade.variant``, from
the gate table of ``ops/kernels/shade.py``): the base kernel on the base
feature set on a CUDA device; the textured variant where a flag of
``kshade.GATE_BITS`` is on, under a texture filter of
``kshade.TEXTURE_FILTERS``; nothing else.  Each gate of the plain body
that the kernels leave out, switched on alone or beside the textured
flags, sends the call to ``render._shade_plain``, and so do a CPU device
and a textured scene under "trilinear"; the tracer's ``shade_fused``
counter counts 0 on the CPU path, and the textured variant's counters
come from its surface record (``kshade.run``).  The cases come from the
gate table itself (``kshade.PLAIN_SCENE``, ``kshade.GATE_BITS`` and
``kshade.KERNEL_CONFIG``), and every has_* or n_* flag of SceneData must
be among them.  The predicate reads only host flags, so these run without
a card."""

import dataclasses

import numpy as np
import pytest
import torch

from tyrant_tpu_torch import render as tr
from tyrant_tpu_torch.camera import Camera
from tyrant_tpu_torch.config import small_config
from tyrant_tpu_torch.ops.kernels import shade as kshade
from tyrant_tpu_torch.scene.procgen import terrain
from tyrant_tpu_torch.scene.scene import Scene, SceneData
from tyrant_tpu_torch.utils import profiling

CFG = small_config(width=16, height=16, num_rays=1 << 10)
CUDA = torch.device("cuda")

# a value that switches each of kshade.KERNEL_CONFIG's fields on
CONFIG_ON = {"fog": "on", "mis": "on", "sampler": "sobol",
             "dispersion": 0.02}
# the SceneData fields behind the properties among the gates
PROPERTY_ON = {"has_envmap": dict(env_meta=(4, 8)),
               "has_textures": dict(has_albedo_tex=True)}
# has_* and n_* attributes of SceneData that are no gate of the plain body:
# the kernel shades spheres (one light among them at most)
NOT_GATES = {"n_spheres"}


def _scene_on(scene, name: str):
    """``scene`` with the gate ``name`` of kshade.PLAIN_SCENE or
    TEXTURED_FLAGS on."""
    if name in PROPERTY_ON:
        return dataclasses.replace(scene, **PROPERTY_ON[name])
    return dataclasses.replace(scene, **{name: type(getattr(scene, name))(1)})


@pytest.fixture(scope="module")
def scene():
    """The small terrain with the seven default spheres (one light)."""
    return Scene.from_triangles(*terrain(n_quads=8, towers=2),
                                builder="numpy").to_device("cpu")


# the textured flags, with has_textures, the property alias of
# has_albedo_tex
TEXTURED_FLAGS = sorted(set(kshade.GATE_BITS) | {"has_textures"})
# the textured flags alone, and all of them together
TEXTURED_SETS = TEXTURED_FLAGS + ["all"]
# what sends a textured call to the plain body: a filter the kernels leave
# out, a gate of kshade.PLAIN_SCENE or KERNEL_CONFIG, a second light
# sphere
PLAIN_BESIDE = {"trilinear": dict(cfg=dict(texture_filter="trilinear")),
                "smooth_normals": dict(scene=dict(smooth_normals=True)),
                "fog": dict(cfg=dict(fog="on")), "mis": dict(cfg=dict(mis="on")),
                "sobol": dict(cfg=dict(sampler="sobol")),
                "envmap": dict(scene=dict(env_meta=(4, 8))),
                "second_light": dict(scene=dict(light_indices=(5, 6)))}


def _textured(scene, gates: str):
    """``scene`` with the textured flag ``gates``, or every one ("all")."""
    names = TEXTURED_FLAGS if gates == "all" else (gates,)
    for name in names:
        scene = _scene_on(scene, name)
    return scene


def test_base_set_on_cuda_takes_the_kernel(scene):
    assert scene.n_spheres == 7 and len(scene.light_indices) == 1
    assert kshade.variant(CFG, scene, CUDA) == kshade.BASE
    assert kshade.variant(CFG, scene, "cuda:0") == kshade.BASE
    normals = dataclasses.replace(CFG, use_kernel_normals="on")
    assert tr.kernel_normals(normals, scene)
    assert kshade.variant(normals, scene, CUDA) == kshade.BASE
    trilinear = dataclasses.replace(CFG, texture_filter="trilinear")
    assert kshade.variant(trilinear, scene, CUDA) == kshade.BASE


def test_cpu_takes_the_plain_body(scene):
    assert kshade.variant(CFG, scene, torch.device("cpu")) is None
    assert kshade.variant(CFG, _textured(scene, "all"),
                          torch.device("cpu")) is None


@pytest.mark.parametrize("gate", sorted(kshade.KERNEL_CONFIG))
def test_config_gate_takes_the_plain_body(scene, gate):
    cfg = dataclasses.replace(CFG, **{gate: CONFIG_ON[gate]})
    assert kshade.variant(cfg, scene, CUDA) is None


@pytest.mark.parametrize("gate", sorted(kshade.PLAIN_SCENE
                                        + tuple(TEXTURED_FLAGS)))
def test_scene_gate_takes_the_plain_body(scene, gate):
    """A gate of PLAIN_SCENE alone; a textured flag under the one filter
    the textured variant leaves out."""
    cfg = CFG if gate in kshade.PLAIN_SCENE \
        else dataclasses.replace(CFG, texture_filter="trilinear")
    sd = _scene_on(scene, gate)
    assert getattr(sd, gate) and kshade.variant(cfg, sd, CUDA) is None


@pytest.mark.parametrize("texture_filter", kshade.TEXTURE_FILTERS)
@pytest.mark.parametrize("gates", TEXTURED_SETS)
def test_textured_gate_takes_the_textured_variant(scene, gates,
                                                  texture_filter):
    cfg = dataclasses.replace(CFG, texture_filter=texture_filter)
    sd = _textured(scene, gates)
    assert kshade.variant(cfg, sd, CUDA) == kshade.TEXTURED
    assert kshade.variant(cfg, scene, CUDA) == kshade.BASE


@pytest.mark.parametrize("beside", sorted(PLAIN_BESIDE))
@pytest.mark.parametrize("gates", TEXTURED_SETS)
def test_textured_gate_beside_a_plain_gate_takes_the_plain_body(
        scene, gates, beside):
    over = PLAIN_BESIDE[beside]
    cfg = dataclasses.replace(CFG, **over.get("cfg", {}))
    sd = dataclasses.replace(_textured(scene, gates), **over.get("scene", {}))
    assert any(getattr(sd, k) for k in kshade.GATE_BITS)
    assert kshade.variant(cfg, sd, CUDA) is None


def test_every_gate_is_listed():
    """Each has_* or n_* attribute of SceneData is a gate of
    kshade.PLAIN_SCENE or a textured flag (not both) or named in
    NOT_GATES, and each config gate has a value here that switches it on:
    a flag added to the plain body without a place in the gate table
    fails here."""
    flags = {k for k in dir(SceneData) if k.startswith(("has_", "n_"))} \
        | {f.name for f in dataclasses.fields(SceneData)
           if f.name.startswith(("has_", "n_"))}
    plain, textured = set(kshade.PLAIN_SCENE), set(TEXTURED_FLAGS)
    assert not plain & textured
    assert flags - NOT_GATES <= plain | textured
    assert set(CONFIG_ON) == set(kshade.KERNEL_CONFIG)
    assert set(PLAIN_BESIDE) >= {"trilinear", "smooth_normals", "fog", "mis",
                                 "sobol", "envmap", "second_light"}


@pytest.mark.parametrize("case", ["light_spheres", "power_pick",
                                  "no_spheres"])
def test_light_pick_and_no_spheres_take_the_plain_body(scene, case):
    cfg, sd = CFG, dataclasses.replace(scene, light_indices=(5, 6),
                                       light_powers=torch.ones(2))
    if case == "power_pick":
        cfg = dataclasses.replace(CFG, light_sampling="power")
        assert tr._light_power_mode(cfg, sd, 2)
    if case == "no_spheres":
        empty = torch.zeros((0, 3))
        sd = dataclasses.replace(scene, sphere_center=empty,
                                 sphere_radius=torch.zeros(0),
                                 sphere_emission=empty, light_index=-1)
        assert sd.n_spheres == 0
    assert kshade.variant(cfg, sd, CUDA) is None


def test_shade_fused_counts_zero_on_the_cpu(scene):
    assert "shade_fused" in profiling.COUNTERS
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        ren = tr.Renderer(scene, CFG, device="cpu")
        cam = Camera()
        cam.position = np.array([0.0, -170.0, 40.0], np.float32)
        profiling.enable()
        ren.step(cam, 2)
        snap = profiling.snapshot()
    finally:
        profiling.disable()
        torch.set_num_threads(n)
    assert [s["counts"]["shade_fused"] for s in snap["steps"]] == [0, 0]
    assert snap["counters"]["cpu"]["shade_fused"] == 0
    assert all(s["counts"]["shadow_slots"] == CFG.num_rays
               for s in snap["steps"])


class _Launches:
    """Stand-ins for the kernels' wrappers on CPU tensors: each records
    its call and returns outputs of the plain body's shapes (the textured
    surface record with the material words given)."""

    def __init__(self, words):
        self.calls, self.words = [], words

    def surface(self, cfg, scene, rays, t, *a):
        self.calls.append("surface")
        rec = torch.zeros((cfg.num_rays, 8))
        rec.view(torch.int32)[:, 7] = self.words
        return rec

    def _out(self, name, cfg):
        self.calls.append(name)
        n = cfg.num_rays
        rays = {k: torch.zeros(n, 3) for k in ("origin", "direction",
                                                "direct")}
        rays.update(pixel=torch.zeros(n, dtype=torch.int32),
                    bounces=torch.zeros(n, dtype=torch.int32),
                    last_specular=torch.zeros(n, dtype=torch.bool))
        shadow = dict(origin=torch.zeros(n, 3), direction=torch.zeros(n, 3),
                      color=torch.zeros(n, 3), max_dist=torch.zeros(n),
                      valid=torch.zeros(n, dtype=torch.bool))
        return torch.zeros(n, 3), torch.zeros(n, dtype=torch.bool), rays, \
            shadow

    def shade_textured(self, cfg, *a):
        return self._out("shade_textured", cfg)

    def shade(self, cfg, *a):
        return self._out("shade", cfg)


@pytest.mark.parametrize("variant", ["base", "textured"])
def test_shade_sends_the_call_to_its_variant(scene, variant, monkeypatch):
    """``render._shade`` where the predicate picks a kernel: one base
    launch, or the textured surface fetch then its shading; with the
    tracer on, the ``fetch_end`` marker between the textured launches and
    ``tex_hits``, ``alpha_pass`` and ``ggx_hits`` read off the surface
    record's material words, ``shade_fused`` the queue."""
    n = CFG.num_rays
    words = torch.zeros(n, dtype=torch.int32)
    words[:5] = tr.PASS
    words[5:8] = tr.GGX | kshade.TEX_HIT_BIT
    words[8:20] = kshade.TEX_HIT_BIT  # mapped DIFF
    fake = _Launches(words)
    for name in ("surface", "shade_textured", "shade"):
        monkeypatch.setattr(kshade, name, getattr(fake, name))
    monkeypatch.setattr(kshade, "variant", lambda *a: (
        kshade.TEXTURED if variant == "textured" else kshade.BASE))
    monkeypatch.setattr(profiling, "mark",
                        lambda dev, k: fake.calls.append(profiling.COLUMNS[k]))
    sd = _textured(scene, "all") if variant == "textured" else scene
    t = torch.full((n,), 1.0)
    rays = {"bounces": torch.zeros(n, dtype=torch.int32)}
    profiling.enable()
    try:
        tr._shade(CFG, sd, None, None, rays, t, None, None, None)
        deferred = {k: int(fn()) for k, fn in
                    profiling._tracer.deferred.items()}
    finally:
        profiling.disable()
    if variant == "base":
        assert fake.calls == ["shade"]
        assert "tex_hits" not in deferred
    else:
        assert fake.calls == ["surface", "fetch_end", "shade_textured"]
        assert {k: deferred[k] for k in ("tex_hits", "alpha_pass",
                                         "ggx_hits")} == dict(
            tex_hits=15, alpha_pass=5, ggx_hits=3)
    assert deferred["shade_fused"] == n
    assert deferred["roulette_kills"] == n  # every slot hit, none survived
