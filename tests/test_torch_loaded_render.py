"""The slice as a whole on the CPU: scenes loaded from files through the
JAX Renderer and the port's Renderer.  A JSON description (a PLY terrain
with vertex normals and instances of an OBJ/MTL asset as a GGX
conductor, IOR-1.7 glass and frosted glass, under the seven spheres,
dispersion 0.02) and a sphere-free, double-sided glTF terrain lit by the
sun alone.  Hit ids are exact; the RNG streams are the JAX package's, so
the per-pixel path counts agree on >= 99.5% of the pixels (a decision
that float drift flips moves one path); the resolved image agrees within
0.01 mean absolute difference; the AOV pass's guides within 1e-4."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tyrant_tpu import render as jr
from tyrant_tpu.camera import Camera as JCamera
from tyrant_tpu.config import small_config
from tyrant_tpu.ops.tonemap import resolve as jresolve
from tyrant_tpu.scene.description import load_description as jload
from tyrant_tpu.scene.scene import Scene as JScene
from tyrant_tpu_torch import render as tr
from tyrant_tpu_torch.camera import Camera
from tyrant_tpu_torch.ops.tonemap import resolve
from tyrant_tpu_torch.scene import files
from tyrant_tpu_torch.scene.description import load_description
from tyrant_tpu_torch.scene.procgen import terrain
from tyrant_tpu_torch.scene.scene import Scene

SUN = (0.05, 0.3)
W = H = 32


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One PyTorch thread: beside the other test workers the default of a
    thread a core oversubscribes the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scenes(case, tmp_path):
    """(JAX Scene, port Scene, render-config overrides) of one file."""
    v0, v1, v2 = terrain(n_quads=16, towers=2)
    if case == "json":
        files.write_ply(tmp_path / "terrain.ply", v0, v1, v2, normals=True)
        asset = files.write_asset_obj(tmp_path)
        path = files.write_description(
            tmp_path / "scene.json", tmp_path / "terrain.ply", asset,
            [(0, -60, 20), (30, -60, 20), (-30, -60, 20), (0, -40, 35)],
            dispersion=0.02)
        jb, tb = jload(path, builder="numpy"), load_description(
            path, builder="numpy")
        assert jb.config == tb.config == {"dispersion": 0.02}
        return jb.scene, tb.scene, tb.config
    path = files.write_glb(tmp_path / "bare.glb", v0, v1, v2)
    return (JScene.load(path, builder="numpy"),
            Scene.load(path, builder="numpy"), {})


def _pose(cls):
    cam = cls()
    cam.position = np.array([0.0, -140.0, 40.0], np.float32)
    cam.vertical_angle = -0.2
    cam.focal_distance = 40.0
    return cam


@pytest.mark.parametrize("case", ["json", "glb"])
def test_loaded_scene_renders_like_jax(case, tmp_path):
    js, ts, over = _scenes(case, tmp_path)
    cfg = small_config(width=W, height=H, num_rays=4096, **over)
    jren = jr.Renderer(js, cfg, sun_position=SUN, donate=False)
    tren = tr.Renderer(ts, cfg, device="cpu", sun_position=SUN)
    sd = tren.scene
    if case == "json":
        assert sd.has_ggx and sd.has_rrefr and sd.has_var_ior
        assert sd.smooth_normals and sd.n_spheres == 7
    else:
        assert sd.n_spheres == 0 and sd.light_index == -1
    jren.step(_pose(JCamera), 8)
    tren.step(_pose(Camera), 8)

    # the next step's extend: hit ids exact, no sphere id without spheres
    rays = tr.merge_queue(cfg, tren.state, tren._last_cam)
    t, ident, is_tri = tr._intersect_scene(rays["origin"], rays["direction"],
                                           sd, tren.tables)
    jt, jid, jtri, _ = jr._intersect_scene(
        jnp.asarray(rays["origin"].numpy()),
        jnp.asarray(rays["direction"].numpy()), jren.scene)
    np.testing.assert_array_equal(ident.numpy(), np.asarray(jid))
    np.testing.assert_array_equal(is_tri.numpy(), np.asarray(jtri))
    if case == "glb":
        assert not bool(((t < 1e20) & ~is_tri).any())

    ja, ta = np.asarray(jren.state.accum), tren.state.accum.numpy()
    assert np.isfinite(ta).all() and ja[:, 3].sum() > 0
    assert (ta[:, 3] == ja[:, 3]).mean() >= 0.995
    diff = np.abs(resolve(tren.state.accum, W, H).numpy()
                  - np.asarray(jresolve(jnp.asarray(ja), W, H)))
    assert diff.mean() < 0.01, diff.mean()


@pytest.mark.parametrize("case", ["json", "glb"])
def test_aovs_match_jax(case, tmp_path):
    """The AOV pass (with the smooth-normal branch on the JSON scene)."""
    js, ts, over = _scenes(case, tmp_path)
    cfg = small_config(width=W, height=H, num_rays=4096, **over)
    tren = tr.Renderer(ts, cfg, device="cpu")
    tren.step(_pose(Camera), 1)
    got = tren.aovs()
    jd = js.to_device()
    want = jr.render_aovs(jd, _pose(JCamera).to_device(cfg), cfg)
    hit = np.asarray(want["depth"]) < 1e20
    assert hit.mean() > 0.3
    for k in ("albedo", "normal", "depth"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-4, atol=1e-4, err_msg=k)
