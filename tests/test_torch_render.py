"""The port's render path against the JAX package on the CPU: raygen from
the same counters, one step from a captured JAX state carried over through
interop, the whole slice against the stored golden render and against the
JAX Renderer, and every RenderConfig field accepted."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tyrant_tpu import render as jr
from tyrant_tpu.camera import Camera as JCamera
from tyrant_tpu.config import small_config
from tyrant_tpu.ops.pallas.traverse_kernel import PacketTables as JPacketTables
from tyrant_tpu.ops.tonemap import resolve as jresolve
from tyrant_tpu.scene.procgen import terrain
from tyrant_tpu.scene.scene import Scene as JScene
from tyrant_tpu_torch import interop
from tyrant_tpu_torch import render as tr
from tyrant_tpu_torch.camera import Camera
from tyrant_tpu_torch.ops.tonemap import resolve
from tyrant_tpu_torch.scene.scene import Scene

SUN = (0.05, 0.3)
_ROOT = __file__.rsplit("/tests/", 1)[0]


def _pose(cam_cls, lens=0.0):
    cam = cam_cls()
    cam.position = np.array([0.0, -170.0, 40.0], np.float32)
    cam.vertical_angle = -0.2
    cam.lens_radius = lens
    cam.focal_distance = 40.0
    return cam


def _jax_camera(cfg, lens=0.0):
    camd = _pose(JCamera, lens).to_device(cfg)
    return camd, interop.camera_from_numpy(
        *(np.asarray(x) for x in (camd.position, camd.direction, camd.right,
                                  camd.up, camd.focal_distance,
                                  camd.lens_radius)), "cpu")


def _terrain():
    return terrain(n_quads=16, towers=2)


def _jax_scene():
    """The terrain with random per-triangle DIFF/SPEC/REFR/PHONG materials
    and colours, so every shade lane runs on triangles too."""
    v0, v1, v2 = _terrain()
    r = np.random.default_rng(4)
    jd = JScene.from_triangles(
        v0, v1, v2, builder="numpy",
        tri_refl=r.integers(0, 4, v0.shape[0]).astype(np.int32),
        tri_color=r.uniform(0.2, 1.0, (v0.shape[0], 3)).astype(np.float32)
    ).to_device()
    leaves = {k: np.asarray(getattr(jd.bvh, k)) for k in interop.SCENE_LEAVES[:4]}
    leaves.update({k: np.asarray(getattr(jd, k))
                   for k in interop.SCENE_LEAVES[4:]})
    td, tables = interop.scene_from_numpy(
        leaves, np.asarray(JPacketTables(jd.bvh).rows), "cpu")
    return jd, td, tables


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("order", ["tiled8", "scan"])
def test_raygen_matches(order):
    cfg = small_config(width=32, height=24, num_rays=4096, raygen_order=order)
    camd, camt = _jax_camera(cfg, lens=0.8)
    for start, frame in ((0, 1), (517, 9), (760, 123456)):
        want = jr._raygen(cfg, camd, jnp.int32(start), jnp.uint32(frame),
                          cfg.height, 0)
        got = tr._raygen(cfg, camt, torch.tensor(start), torch.tensor(frame))
        np.testing.assert_array_equal(_np(got["pixel"]), _np(want["pixel"]))
        for k in ("origin", "direction"):
            np.testing.assert_allclose(_np(got[k]), _np(want[k]), rtol=1e-5,
                                       atol=1e-6)


def test_golden_snapshot_config():
    """test_golden_snapshot's render (16x16, 1024 rays, 6 steps, spheres
    only) through the port's Renderer."""
    cfg = small_config(width=16, height=16, num_rays=1 << 10)
    r = tr.Renderer(Scene.load(None), cfg, device="cpu")
    cam = Camera()
    cam.position = np.array([0.0, -170.0, 40.0], np.float32)
    cam.vertical_angle = -0.10
    r.step(cam, 6)
    acc = r.state.accum.numpy()
    want = np.load(f"{_ROOT}/tests/data/golden_spheres.npz")["accum"]
    assert abs(acc[:, 3].sum() - want[:, 3].sum()) <= 0.005 * want[:, 3].sum()
    diff = np.abs(resolve(torch.from_numpy(acc), 16, 16).numpy()
                  - np.asarray(jresolve(jnp.asarray(want), 16, 16)))
    assert diff.mean() < 0.03, diff.mean()


def test_terrain_matches_jax_renderer():
    cfg = small_config(width=32, height=32, num_rays=4096)
    jren = jr.Renderer(JScene.from_triangles(*_terrain(), builder="numpy"),
                       cfg, sun_position=SUN, donate=False)
    jren.step(_pose(JCamera), 8)
    tren = tr.Renderer(Scene.from_triangles(*_terrain(), builder="numpy"),
                       cfg, device="cpu", sun_position=SUN)
    tren.step(_pose(Camera), 8)
    ja, ta = np.asarray(jren.state.accum), tren.state.accum.numpy()
    assert ja[:, 3].sum() > 0
    assert abs(ta[:, 3].sum() - ja[:, 3].sum()) <= 0.005 * ja[:, 3].sum()
    diff = np.abs(resolve(tren.state.accum, 32, 32).numpy()
                  - np.asarray(jresolve(jnp.asarray(ja), 32, 32)))
    assert diff.mean() < 0.03, diff.mean()
    img = tren.image()
    assert img.shape == (32, 32, 3) and torch.isfinite(img).all()


@pytest.mark.parametrize("field,value", [
    ("fog_falloff", 0.02), ("fog", "on"), ("sampler", "sobol"),
    ("adaptive_sampling", "on"), ("track_variance", "on"),
    ("bokeh_rotation", 0.3), ("projection", "fisheye"),
    ("motion_blur", 0.5), ("crop", (0, 0, 8, 8)), ("bokeh_blades", 6),
    ("ortho_height", 20.0), ("radiance_clamp", 4.0), ("seed", 3),
    ("adaptive_interval", 8), ("fisheye_fov_degrees", 120.0),
    ("adaptive_gamma", 0.5)])
def test_unported_config_fields_raise(field, value):
    """Every field once refused here is ported: a Renderer under it (with the fields it works with: fog's slab, a
    lens for the bokeh, the projection of its size, adaptive sampling for
    its interval and gamma) builds and steps through a pose change (the
    name is kept)."""
    cfg = dataclasses.replace(small_config(16, 16, 1024), **{field: value})
    with_ = {"fog": dict(fog="on", fog_z_min=-20.0, fog_z_max=60.0),
             "fog_falloff": dict(fog="on", fog_z_min=-20.0, fog_z_max=60.0),
             "fisheye_fov_degrees": dict(projection="fisheye"),
             "ortho_height": dict(projection="ortho"),
             "adaptive_interval": dict(adaptive_sampling="on"),
             "adaptive_gamma": dict(adaptive_sampling="on",
                                    adaptive_interval=1)}
    cfg = dataclasses.replace(cfg, **with_.get(field, {}))
    r = tr.Renderer(Scene.load(None), cfg, device="cpu")
    assert getattr(r.cfg, field) == value
    if field == "fog":
        assert tr._fog_on(r.cfg)
    cam = _pose(Camera, lens=2.0 if field.startswith("bokeh") else 0.0)
    r.step(cam, 2)
    cam.horizontal_angle += 0.05
    r.step(cam, 2)
    assert torch.isfinite(r.state.accum).all()
    assert float(r.state.accum[:, 3].sum()) > 0
    if tr._moments(cfg):
        assert r.noise_estimate() > 0


def test_pose_and_sun_changes_reset_accumulation():
    cfg = small_config(16, 16, 1024)
    r = tr.Renderer(Scene.load(None), cfg, device="cpu")
    cam = _pose(Camera)
    r.step(cam, 2)
    paths = float(r.state.accum[:, 3].sum())
    r.step(cam, 1)  # same pose: keeps accumulating
    assert float(r.state.accum[:, 3].sum()) > paths
    r.set_sun((0.2, 0.35))
    assert float(r.state.accum.abs().sum()) == 0.0
    assert int(r.state.n_carried) == 0
    r.step(cam, 1)
    paths = float(r.state.accum[:, 3].sum())
    cam.horizontal_angle += 0.1
    r.step(cam, 1)  # new pose: only this step's paths remain
    assert 0 < float(r.state.accum[:, 3].sum()) <= cfg.num_rays


def test_packet_kernel_modes_render_alike():
    """CPU tensors take the plain walk whatever the traversal generation,
    so every mode renders the same accumulation."""
    accums = []
    for mode in ("mono", "wave", "auto"):
        cfg = small_config(16, 16, 1024, packet_kernel_mode=mode)
        r = tr.Renderer(Scene.from_triangles(*_terrain(), builder="numpy"),
                        cfg, device="cpu", sun_position=SUN)
        r.step(_pose(Camera), 3)
        accums.append(r.state.accum)
    assert accums[0][:, 3].sum() > 0
    for a in accums[1:]:
        assert torch.equal(a, accums[0])


@pytest.mark.parametrize("mode", ["auto", "mono", "wave", "wave-unsafe"])
def test_pick_wave_per_stage(mode):
    """"wave" and its old spelling take the wave kernel in every stage;
    "mono" and "auto" the per-thread kernel."""
    cfg = small_config(16, 16, 1024, packet_kernel_mode=mode)
    assert tr._pick_wave(cfg) == mode.startswith("wave")


def test_tpu_selectors_are_accepted():
    cfg = small_config(16, 16, 1024, use_packet_kernel="on",
                       use_accum_kernel="off", adaptive_connect="auto",
                       fuse_step_chains="on", use_kernel_normals="on")
    tr.Renderer(Scene.load(None), cfg, device="cpu")
