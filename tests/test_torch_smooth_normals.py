"""Smooth vertex-normal shading in the port: the four cases of
test_smooth_normals, each also held against the JAX package on the same
inputs.  Normals ride the tri_attr row; barycentrics come from the hit
point through the dual basis.  Directions agree within 1e-4 (the
dual-basis dots and the renormalisation round differently in XLA)."""

import jax.numpy as jnp
import numpy as np
import torch

from tyrant_tpu import render as jr
from tyrant_tpu import sky as jsky
from tyrant_tpu.config import small_config
from tyrant_tpu.scene.obj import load_obj_scene as jload_obj_scene
from tyrant_tpu.scene.ply import load_ply_full as jload_ply_full
from tyrant_tpu.scene.scene import Scene as JScene
from tyrant_tpu_torch import render as tr
from tyrant_tpu_torch import sky as tsky
from tyrant_tpu_torch.camera import Camera
from tyrant_tpu_torch.ops.kernels.traverse import PacketTables
from tyrant_tpu_torch.scene.obj import load_obj_scene
from tyrant_tpu_torch.scene.ply import load_ply_full
from tyrant_tpu_torch.scene.scene import SPEC, Scene

CFG = small_config(width=16, height=16, num_rays=1 << 10)
SUN = (0.05, 0.3)
TOL = dict(rtol=1e-4, atol=1e-4)


def test_obj_vn_parsing(tmp_path):
    (tmp_path / "t.obj").write_text(
        "v 0 0 0\nv 1 0 0\nv 0 1 0\n"
        "vn 0 0 1\nvn 0.707 0 0.707\nvn 0 0.707 0.707\n"
        "f 1//1 2//2 3//3\n")
    m = load_obj_scene(str(tmp_path / "t.obj"))
    assert m.normals is not None and m.normals.shape == (1, 3, 3)
    np.testing.assert_allclose(m.normals[0, 1], [0.707, 0, 0.707])
    np.testing.assert_array_equal(
        m.normals, jload_obj_scene(str(tmp_path / "t.obj")).normals)


def test_ply_normal_parsing(tmp_path):
    (tmp_path / "t.ply").write_text(
        "ply\nformat ascii 1.0\n"
        "element vertex 3\n"
        "property float x\nproperty float y\nproperty float z\n"
        "property float nx\nproperty float ny\nproperty float nz\n"
        "element face 1\nproperty list uchar int vertex_indices\n"
        "end_header\n"
        "0 0 0 0 0 1\n1 0 0 1 0 0\n0 1 0 0 1 0\n"
        "3 0 1 2\n")
    path = str(tmp_path / "t.ply")
    v, f, n = load_ply_full(path)
    assert v.shape == (3, 3) and f.shape == (1, 3)
    np.testing.assert_allclose(n, np.eye(3)[[2, 0, 1]])
    np.testing.assert_array_equal(n, jload_ply_full(path)[2])
    sc = Scene.load(path, builder="numpy")
    assert sc.tri_vn is not None and sc.tri_vn.shape == (1, 3, 3)
    sd = sc.to_device("cpu")
    assert sd.smooth_normals
    np.testing.assert_array_equal(
        sd.tri_attr.numpy(),
        np.asarray(JScene.load(path, builder="numpy").to_device().tri_attr))


def _quad(scene_cls, tilt=0.4, vn=None):
    """test_smooth_normals' floor quad: corner normals tilt toward +x on
    the +x side (or the given ``vn``), SPEC so the bounce mirrors the
    shading normal."""
    half = 200.0
    v0 = np.array([[-half, -half, 0], [half, half, 0]], np.float32)
    v1 = np.array([[half, -half, 0], [-half, half, 0]], np.float32)
    v2 = np.array([[-half, half, 0], [half, -half, 0]], np.float32)
    n = np.cross(v1 - v0, v2 - v0)
    flip = n[:, 2] < 0
    v1[flip], v2[flip] = v2[flip].copy(), v1[flip].copy()

    def nrm_of(p):
        out = np.stack([tilt * p[:, 0] / half, np.zeros(p.shape[0]),
                        np.ones(p.shape[0])], axis=1)
        return (out / np.linalg.norm(out, axis=1, keepdims=True)) \
            .astype(np.float32)

    if vn is None:
        vn = np.stack([nrm_of(v0), nrm_of(v1), nrm_of(v2)], axis=1)
    return scene_cls.from_triangles(
        v0, v1, v2, builder="numpy", tri_refl=np.full(2, SPEC, np.int32),
        tri_color=np.ones((2, 3), np.float32), tri_vn=vn)


def _bounce(scene_t, scene_j):
    """The port's raygen, extend and shade of one step from a camera
    above the quad, and the JAX package's shade on the same hits: (hit
    mask, ray directions, port bounce directions, JAX bounce
    directions)."""
    cam = Camera()
    cam.position = np.array([0.0, 0.0, 50.0], np.float32)
    cam.vertical_angle = -1.2
    sd = scene_t.to_device("cpu")
    gen = tr._raygen(CFG, cam.to_device(CFG, "cpu"), torch.tensor(0),
                     torch.tensor(1))
    t, ident, is_tri = tr._intersect_scene(gen["origin"], gen["direction"],
                                           sd, PacketTables(sd.bvh))
    _, _, nxt, _ = tr._shade(CFG, sd, tsky.SkyParams(CFG.sky),
                             tsky.sun_direction_from_position(SUN, "cpu"),
                             gen, t, ident, is_tri, torch.tensor(1))
    jgen = {k: jnp.asarray(v.numpy()) for k, v in gen.items()}
    _, _, _, jnxt, _ = jr._shade(
        CFG, scene_j.to_device(), jsky.SkyParams(CFG.sky),
        jsky.sun_direction_from_position(jnp.asarray(SUN)), jgen,
        jnp.asarray(t.numpy()), jnp.asarray(ident.numpy()),
        jnp.asarray(is_tri.numpy()), jnp.asarray(1, jnp.uint32))
    hits = is_tri.numpy()
    return (hits, gen["direction"].numpy()[hits],
            nxt["direction"].numpy()[hits],
            np.asarray(jnxt["direction"])[hits])


def test_interpolated_normal_drives_reflection():
    """SPEC reflection off the tilted-normal quad uses the normal
    interpolated at the hit point; zero-tilt corner normals reproduce the
    flat mirror; both equal the JAX package's bounce."""
    hits, d, d_out, j_out = _bounce(_quad(Scene), _quad(JScene))
    assert hits.mean() > 0.5
    np.testing.assert_allclose(d_out, j_out, **TOL)
    n_rec = d_out - d
    n_rec /= np.linalg.norm(n_rec, axis=1, keepdims=True)
    assert _quad(Scene).to_device("cpu").smooth_normals
    # the left and right halves of the image (rays' x) hit the quad's -x
    # and +x sides, whose normals tilt apart
    x_side = d[:, 0]
    lo, hi = n_rec[x_side < -0.2], n_rec[x_side > 0.2]
    assert lo[:, 0].mean() < -0.05 and hi[:, 0].mean() > 0.05
    _, d2, d2_out, j2_out = _bounce(_quad(Scene, tilt=0.0),
                                    _quad(JScene, tilt=0.0))
    np.testing.assert_allclose(d2_out, j2_out, **TOL)
    flat = d2 - 2 * (d2 * [0, 0, 1]).sum(1, keepdims=True) * [0, 0, 1]
    np.testing.assert_allclose(d2_out, flat, atol=1e-4)


def test_smooth_flag_falls_back_to_geometric():
    """Triangles with degenerate (zero) corner normals shade with the
    geometric normal."""
    vn = np.zeros((2, 3, 3), np.float32)
    sd = _quad(Scene, vn=vn).to_device("cpu")
    assert sd.smooth_normals
    assert (sd.tri_attr.numpy()[:2, 25] == 0.0).all()
    _, d, d_out, j_out = _bounce(_quad(Scene, vn=vn), _quad(JScene, vn=vn))
    np.testing.assert_allclose(d_out, j_out, **TOL)
    np.testing.assert_allclose(d_out[:, 2], -d[:, 2], atol=1e-5)
    np.testing.assert_allclose(d_out[:, :2], d[:, :2], atol=1e-5)
