"""Kernel-carried normals (``use_kernel_normals``) against the JAX
package on the CPU: the plain ``closest_hit(normals=True)`` against the
Pallas kernel's normals output in interpret mode, mono and wave; the
``tri_default_mat`` flag against the JAX flag on four scenes; shade's
gather-free branch against the JAX one; and the interactive preset
flown for four frames through both Renderers."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tyrant_tpu import render as jr
from tyrant_tpu import sky as jsky
from tyrant_tpu.camera import Camera as JCamera
from tyrant_tpu.config import interactive_config as j_interactive_config
from tyrant_tpu.ops.intersect import intersect_spheres as j_intersect_spheres
from tyrant_tpu.ops.pallas.traverse_kernel import (PacketTables as JPacketTables,
                                                   closest_hit_packets as j_closest_pk)
from tyrant_tpu.ops.tonemap import resolve as jresolve
from tyrant_tpu.scene.procgen import terrain
from tyrant_tpu.scene.scene import Scene as JScene
from tyrant_tpu_torch import interop
from tyrant_tpu_torch import render as tr
from tyrant_tpu_torch import sky as tsky
from tyrant_tpu_torch.bench import interactive
from tyrant_tpu_torch.camera import Camera
from tyrant_tpu_torch.config import interactive_config
from tyrant_tpu_torch.ops import traverse as plain
from tyrant_tpu_torch.ops.kernels import traverse as ktrav
from tyrant_tpu_torch.ops.tonemap import resolve
from tyrant_tpu_torch.scene import files as scene_files
from tyrant_tpu_torch.scene.scene import Scene

SUN = (0.05, 0.3)
# normals against the JAX package: within 1e-6 of the normal's length
# (XLA contracts the cross product's a*b - c*d into a fused multiply-add,
# so a component may sit an ulp away from the eagerly rounded one);
# normalised, within 1e-6
NORMAL_RTOL = 1e-6


def _close_normals(got, want):
    scale = np.linalg.norm(want, axis=1)
    err = np.abs(got - want).max(axis=1)
    assert (err <= NORMAL_RTOL * scale).all(), \
        f"{int((err > NORMAL_RTOL * scale).sum())} normals differ"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The renders here run for seconds on the CPU; beside the other test
    workers, PyTorch's default of a thread a core oversubscribes the
    machine, so each test runs on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _terrain():
    return terrain(n_quads=16, towers=2)


def _rays(n_rays=1024, seed=3):
    """tests/test_packet_kernel.py's rays: from above the terrain's front,
    tilted down."""
    r = np.random.default_rng(seed)
    o = np.tile([[0.0, -150.0, 60.0]], (n_rays, 1)).astype(np.float32) \
        + r.normal(0, 5, (n_rays, 3)).astype(np.float32)
    d = r.normal(size=(n_rays, 3)).astype(np.float32)
    d[:, 2] -= 0.5
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d.astype(np.float32)


@pytest.mark.parametrize("wave", [False, True])
def test_plain_normals_match_pallas_kernel(wave):
    """ids exact, t within an ulp (rtol 1e-6); the normals within
    NORMAL_RTOL of the Pallas kernel's carried cross(e1, e2), normalised
    within 1e-6 of tri_shade's normals, zero on a miss; and the wrapper's
    plain version bit for bit the walk plus hit_normals."""
    jd = JScene.from_triangles(*_terrain(), builder="numpy").to_device()
    td = Scene.from_triangles(*_terrain(), builder="numpy").to_device("cpu")
    o, d = _rays()
    jt, jid, jn = (np.asarray(x) for x in j_closest_pk(
        jnp.asarray(o), jnp.asarray(d), JPacketTables(jd.bvh),
        interpret=True, wave=wave, normals=True))
    tables = ktrav.PacketTables(td.bvh)
    tt, tid, tn = (x.numpy() for x in ktrav.closest_hit_packets(
        torch.from_numpy(o), torch.from_numpy(d), tables, wave=wave,
        normals=True))
    hit = jid >= 0
    assert hit.mean() > 0.2
    np.testing.assert_array_equal(tid, jid)
    # XLA rounds the interpret-mode Möller-Trumbore its own way: a hit's t
    # may sit an ulp away from the eagerly rounded one
    np.testing.assert_allclose(tt, jt, rtol=1e-6, atol=0)
    _close_normals(tn, jn)
    assert (tn[~hit] == 0).all() and (jn[~hit] == 0).all()
    unit = tn[hit] / np.linalg.norm(tn[hit], axis=1, keepdims=True)
    np.testing.assert_allclose(unit, td.tri_shade.numpy()[tid[hit], 0:3],
                               rtol=0, atol=1e-6)
    # the wrapper's plain version is the walk plus hit_normals
    t2, id2 = plain.closest_hit(torch.from_numpy(o), torch.from_numpy(d),
                                td.bvh)
    np.testing.assert_array_equal(t2.numpy(), tt)
    np.testing.assert_array_equal(
        plain.hit_normals(td.bvh.tri_packed, id2).numpy(), tn)


def _scenes(tmp_path):
    ply = str(tmp_path / "smooth.ply")
    scene_files.write_ply(ply, *_terrain(), normals=True)
    flat = str(tmp_path / "flat.ply")
    scene_files.write_ply(flat, *_terrain())
    obj = scene_files.write_asset_obj(tmp_path)
    return {"default": None, "terrain ply": flat, "obj/mtl": obj,
            "smooth ply": ply}


def test_tri_default_mat_matches_jax(tmp_path):
    flags = {}
    for name, path in _scenes(tmp_path).items():
        want = JScene.load(path, builder="numpy").to_device().tri_default_mat
        got = Scene.load(path, builder="numpy").to_device("cpu")
        assert got.tri_default_mat == want, name
        flags[name] = want
    v0, v1, v2 = _terrain()
    assert Scene.from_triangles(v0, v1, v2, builder="numpy") \
        .to_device("cpu").tri_default_mat
    assert flags["terrain ply"] and not flags["smooth ply"] \
        and not flags["obj/mtl"]


def test_shade_gather_free_branch_matches_jax():
    """The port's _shade with the traversal's normals against the JAX
    _shade(tri_normal=...) on the same queue: colour, survival and the
    shadow flags equal everywhere, the next rays and shadow rays within
    1e-5 on hit slots (tests/test_packet_kernel.py's tolerance)."""
    from tyrant_tpu.config import RenderConfig as JRenderConfig
    from tyrant_tpu_torch.config import RenderConfig
    jd = JScene.from_triangles(*_terrain(), builder="numpy").to_device()
    assert jd.tri_default_mat
    leaves = {k: np.asarray(getattr(jd.bvh, k))
              for k in interop.SCENE_LEAVES[:4]}
    leaves.update({k: np.asarray(getattr(jd, k))
                   for k in interop.SCENE_LEAVES[4:]})
    td, tables = interop.scene_from_numpy(
        leaves, np.asarray(JPacketTables(jd.bvh).rows), "cpu",
        flags={k: getattr(jd, k) for k in interop.SCENE_FLAGS})
    assert td.tri_default_mat
    jcfg = JRenderConfig(width=64, height=32, num_rays=2048, max_bounces=3)
    tcfg = RenderConfig(width=64, height=32, num_rays=2048, max_bounces=3)
    cam = JCamera(position=np.float32([0.0, -150.0, 60.0]),
                  vertical_angle=-0.3)
    camd = cam.to_device(jcfg)
    camt = interop.camera_from_numpy(
        *(np.asarray(x) for x in (camd.position, camd.direction, camd.right,
                                  camd.up, camd.focal_distance,
                                  camd.lens_radius)), "cpu")
    jsun = jsky.sun_direction_from_position(jnp.asarray(SUN))
    tsun = tsky.sun_direction_from_position(SUN, "cpu")
    gen = jr._raygen(jcfg, camd, jnp.asarray(0), jnp.asarray(1, jnp.uint32),
                     jcfg.height, 0)
    jt, jid, jtri, _ = jr._intersect_scene(gen["origin"], gen["direction"],
                                           jd)
    # the Pallas kernel's normals, seeded with the sphere pass like extend
    t_sph, _ = j_intersect_spheres(gen["origin"], gen["direction"],
                                   jd.sphere_center, jd.sphere_radius)
    _, _, jn = j_closest_pk(gen["origin"], gen["direction"],
                            JPacketTables(jd.bvh), t_init=t_sph,
                            interpret=True, normals=True)
    j_out = jr._shade(jcfg, jd, jsky.SkyParams(jcfg.sky), jsun, gen, jt, jid,
                      jtri, jnp.asarray(1, jnp.uint32), tri_normal=jn)
    trays = {k: torch.from_numpy(np.array(v)) for k, v in gen.items()}
    tt, tid, ttri, tn = tr._intersect_scene(trays["origin"],
                                            trays["direction"], td, tables,
                                            normals=True)
    np.testing.assert_array_equal(tid.numpy(), np.asarray(jid))
    _close_normals(tn.numpy(), np.asarray(jn))
    tc, tsurv, tnext, tshadow = tr._shade(
        tcfg, td, tsky.SkyParams(tcfg.sky), tsun, trays,
        torch.from_numpy(np.array(jt)), tid, ttri, torch.tensor(1),
        tri_normal=tn)
    jc, _, jsurv, jnext, jshadow = j_out
    hit = np.asarray(jt) < 1e19
    assert hit.mean() > 0.2
    np.testing.assert_array_equal(tsurv.numpy(), np.asarray(jsurv))
    np.testing.assert_array_equal(tshadow["valid"].numpy(),
                                  np.asarray(jshadow["valid"]))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-5)
    for k in ("origin", "direction", "direct"):
        np.testing.assert_allclose(tnext[k].numpy()[hit],
                                   np.asarray(jnext[k])[hit], atol=1e-5)
    for k in ("origin", "direction", "color"):
        np.testing.assert_allclose(tshadow[k].numpy()[hit],
                                   np.asarray(jshadow[k])[hit], atol=1e-5)
    # and the port's two branches agree with each other the same way
    gc, gsurv, gnext, _ = tr._shade(
        tcfg, td, tsky.SkyParams(tcfg.sky), tsun, trays, tt, tid, ttri,
        torch.tensor(1))
    np.testing.assert_array_equal(gsurv.numpy(), tsurv.numpy())
    np.testing.assert_allclose(gc.numpy(), tc.numpy(), atol=1e-5)
    np.testing.assert_allclose(gnext["direction"].numpy()[hit],
                               tnext["direction"].numpy()[hit], atol=1e-5)


def test_interactive_flythrough_matches_jax_renderer():
    """Four frames of the fly-through (tyrant_tpu_torch.bench.interactive)
    under interactive_config(64, 32, 2048) through both Renderers on the
    terrain with the seven spheres: the port takes the kernel-normal
    branch with the plain normals, the JAX package (interpret mode) the
    gather.  tests/test_torch_render.py's Renderer tolerance: the path
    counts within 0.5%, the resolved images within 0.03 mean."""
    v0, v1, v2 = _terrain()
    jcfg = j_interactive_config(width=64, height=32, num_rays=2048)
    tcfg = interactive_config(width=64, height=32, num_rays=2048)
    assert tcfg.use_kernel_normals == "on"
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    jren = jr.Renderer(JScene.from_triangles(v0, v1, v2, builder="numpy"),
                       jcfg, sun_position=SUN, donate=False)
    tren = tr.Renderer(Scene.from_triangles(v0, v1, v2, builder="numpy"),
                       tcfg, device="cpu", sun_position=SUN)
    assert tren.scene.tri_default_mat and not tren.captured
    jcam, tcam = JCamera(), Camera()
    for cam in (jcam, tcam):
        cam.position = np.array([0.0, -170.0, 40.0], np.float32)
        cam.vertical_angle = -0.2
    for i in range(4):
        interactive.fly_path(jcam, i)
        jren.step(jcam, 1)
        img = interactive.frame(tren, tcam, i)
        np.testing.assert_array_equal(tcam.position, jcam.position)
        ja, ta = np.asarray(jren.state.accum), tren.state.accum.numpy()
        assert ja[:, 3].sum() > 0
        assert abs(ta[:, 3].sum() - ja[:, 3].sum()) <= 0.005 * ja[:, 3].sum()
        diff = np.abs(resolve(tren.state.accum, 64, 32).numpy()
                      - np.asarray(jresolve(jnp.asarray(ja), 64, 32)))
        assert diff.mean() < 0.03, diff.mean()
        assert img.shape == (32, 64, 3) and img.dtype == np.uint8
