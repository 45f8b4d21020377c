"""Which shade calls the shade kernel takes (``render._fused_shade``): the
base feature set on a CUDA device, and nothing else.  Each gate of the
plain body that the kernel leaves out, switched on alone, sends the call
to ``render._shade_plain``, and so does a CPU device; the tracer's
``shade_fused`` counter counts 0 on the CPU path.  The cases come from
the predicate's own gate lists (``render.SHADE_PLAIN_SCENE`` and
``render.SHADE_KERNEL_CONFIG``), and every has_* or n_* flag of SceneData
must be among them.  The predicate reads only host flags, so these run
without a card."""

import dataclasses

import numpy as np
import pytest
import torch

from tyrant_tpu_torch import render as tr
from tyrant_tpu_torch.camera import Camera
from tyrant_tpu_torch.config import small_config
from tyrant_tpu_torch.scene.procgen import terrain
from tyrant_tpu_torch.scene.scene import Scene, SceneData
from tyrant_tpu_torch.utils import profiling

CFG = small_config(width=16, height=16, num_rays=1 << 10)
CUDA = torch.device("cuda")

# a value that switches each of render.SHADE_KERNEL_CONFIG's fields on
CONFIG_ON = {"fog": "on", "mis": "on", "sampler": "sobol",
             "dispersion": 0.02}
# the SceneData fields behind the properties of render.SHADE_PLAIN_SCENE
PROPERTY_ON = {"has_envmap": dict(env_meta=(4, 8)),
               "has_textures": dict(has_albedo_tex=True)}
# has_* and n_* attributes of SceneData that are no gate of the plain body:
# the kernel shades spheres (one light among them at most)
NOT_GATES = {"n_spheres"}


def _scene_on(scene, name: str):
    """``scene`` with the gate ``name`` of render.SHADE_PLAIN_SCENE on."""
    if name in PROPERTY_ON:
        return dataclasses.replace(scene, **PROPERTY_ON[name])
    return dataclasses.replace(scene, **{name: type(getattr(scene, name))(1)})


@pytest.fixture(scope="module")
def scene():
    """The small terrain with the seven default spheres (one light)."""
    return Scene.from_triangles(*terrain(n_quads=8, towers=2),
                                builder="numpy").to_device("cpu")


def test_base_set_on_cuda_takes_the_kernel(scene):
    assert scene.n_spheres == 7 and len(scene.light_indices) == 1
    assert tr._fused_shade(CFG, scene, CUDA)
    assert tr._fused_shade(CFG, scene, "cuda:0")
    normals = dataclasses.replace(CFG, use_kernel_normals="on")
    assert scene.tri_default_mat and tr._fused_shade(normals, scene, CUDA)


def test_cpu_takes_the_plain_body(scene):
    assert not tr._fused_shade(CFG, scene, torch.device("cpu"))


@pytest.mark.parametrize("gate", sorted(tr.SHADE_KERNEL_CONFIG))
def test_config_gate_takes_the_plain_body(scene, gate):
    cfg = dataclasses.replace(CFG, **{gate: CONFIG_ON[gate]})
    assert not tr._fused_shade(cfg, scene, CUDA)


@pytest.mark.parametrize("gate", sorted(tr.SHADE_PLAIN_SCENE))
def test_scene_gate_takes_the_plain_body(scene, gate):
    sd = _scene_on(scene, gate)
    assert getattr(sd, gate) and not tr._fused_shade(CFG, sd, CUDA)


def test_every_gate_is_listed():
    """Each has_* or n_* attribute of SceneData is a gate of
    render.SHADE_PLAIN_SCENE or named in NOT_GATES, and each config gate
    has a value here that switches it on: a flag added to the plain body
    without a place in the gate list fails here."""
    flags = {k for k in dir(SceneData) if k.startswith(("has_", "n_"))} \
        | {f.name for f in dataclasses.fields(SceneData)
           if f.name.startswith(("has_", "n_"))}
    assert flags - NOT_GATES <= set(tr.SHADE_PLAIN_SCENE)
    assert set(CONFIG_ON) == set(tr.SHADE_KERNEL_CONFIG)


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
    assert not tr._fused_shade(cfg, sd, CUDA)


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
