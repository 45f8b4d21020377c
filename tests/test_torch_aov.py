"""The port's AOV pass (``render.render_aovs``) against the JAX package's on
the CPU: one captured JAX scene (a small terrain and the seven spheres)
and camera fed to both at 32x32.  The JAX side runs its packet kernel of
the generation ``packet_kernel_mode`` selects, in interpret mode.

Tolerances: the miss mask is equal and the albedo exact; normals within
atol 1e-5; depth within rtol 1e-5 on triangle hits and atol 2e-3 on
sphere hits (the ground sphere's roots cancel at 1e8 magnitudes and XLA
contracts them into FMAs).  A pixel whose closest hit is an epsilon tie
(two surfaces within 1e-3 of each other, the accept order decides) may
show the other surface's albedo and normal."""

import numpy as np
import pytest

from tyrant_tpu import render as jr
from tyrant_tpu.camera import Camera as JCamera
from tyrant_tpu.config import small_config as jsmall_config
from tyrant_tpu.ops.pallas.traverse_kernel import PacketTables as JPacketTables
from tyrant_tpu.scene.procgen import terrain
from tyrant_tpu.scene.scene import Scene as JScene
from tyrant_tpu_torch import interop
from tyrant_tpu_torch import render as tr
from tyrant_tpu_torch.camera import Camera
from tyrant_tpu_torch.config import small_config
from tyrant_tpu_torch.ops.kernels import traverse as ktrav
from tyrant_tpu_torch.scene.scene import Scene

W = H = 32
TIE = 1e-3


def _pose(cam_cls):
    cam = cam_cls()
    cam.position = np.array([0.0, -170.0, 40.0], np.float32)
    cam.vertical_angle = -0.2
    return cam


def _inputs(mode):
    jcfg = jsmall_config(W, H, 1024, packet_kernel_mode=mode)
    jd = JScene.from_triangles(*terrain(n_quads=16, towers=2),
                               builder="numpy").to_device()
    jt = JPacketTables(jd.bvh)
    leaves = {k: np.asarray(getattr(jd.bvh, k))
              for k in interop.SCENE_LEAVES[:4]}
    leaves.update({k: np.asarray(getattr(jd, k))
                   for k in interop.SCENE_LEAVES[4:]})
    td, tables = interop.scene_from_numpy(leaves, np.asarray(jt.rows), "cpu")
    camd = _pose(JCamera).to_device(jcfg)
    camt = interop.camera_from_numpy(
        *(np.asarray(x) for x in (camd.position, camd.direction, camd.right,
                                  camd.up, camd.focal_distance,
                                  camd.lens_radius)), "cpu")
    return jcfg, jd, jt, camd, td, tables, camt


def _is_triangle(cfg, td, tables, camt):
    """Which pixels' closest hit is a triangle, from the port's own pass
    over the same pixel-centre rays."""
    o, d = tr.aov_primaries(camt, cfg)
    _, _, is_tri = tr._intersect_scene(o, d, td, tables)
    return is_tri.numpy().reshape(H, W)


@pytest.mark.parametrize("mode", ["mono", "wave"])
def test_render_aovs_matches_jax(mode):
    jcfg, jd, jt, camd, td, tables, camt = _inputs(mode)
    want = {k: np.asarray(v) for k, v in
            jr.render_aovs(jd, camd, jcfg, packet_tables=jt).items()}
    cfg = small_config(W, H, 1024, packet_kernel_mode=mode)
    got = {k: v.numpy() for k, v in tr.render_aovs(td, camt, cfg,
                                                   tables).items()}
    assert ktrav.launches == ktrav.launches_wave == 0  # plain walk on CPU

    miss = want["depth"] >= 1e20
    np.testing.assert_array_equal(got["depth"] >= 1e20, miss)
    is_tri = _is_triangle(cfg, td, tables, camt)
    sphere = ~miss & ~is_tri
    assert is_tri.sum() > 50 and sphere.sum() > 50 and miss.sum() > 0

    tie = (np.abs(got["depth"] - want["depth"]) <= TIE) \
        & (np.any(got["albedo"] != want["albedo"], axis=-1)
           | np.any(np.abs(got["normal"] - want["normal"]) > 1e-5, axis=-1))
    assert tie.sum() <= 4, tie.sum()
    same = ~tie
    np.testing.assert_array_equal(got["albedo"][same], want["albedo"][same])
    np.testing.assert_allclose(got["normal"][same], want["normal"][same],
                               rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got["albedo"][miss], 1.0)
    np.testing.assert_array_equal(got["normal"][miss], 0.0)
    np.testing.assert_allclose(got["depth"][is_tri], want["depth"][is_tri],
                               rtol=1e-5, atol=0)
    np.testing.assert_allclose(got["depth"][sphere], want["depth"][sphere],
                               rtol=0, atol=2e-3)


def test_aovs_need_a_step_and_are_cached_per_pose():
    cfg = small_config(16, 16, 1024, denoise="on")
    r = tr.Renderer(Scene.from_triangles(*terrain(n_quads=8, towers=1),
                                         builder="numpy"), cfg, device="cpu")
    with pytest.raises(RuntimeError, match="step"):
        r.aovs()
    cam = _pose(Camera)
    r.step(cam, 1)
    a = r.aovs()
    assert a["albedo"].shape == (16, 16, 3) and a["depth"].shape == (16, 16)
    r.step(cam, 1)
    assert r.aovs() is a  # same pose: the cached pass
    cam.horizontal_angle += 0.1
    r.step(cam, 1)
    assert r.aovs() is not a
