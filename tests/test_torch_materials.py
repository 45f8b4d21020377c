"""The port's GGX, rough-glass (RREFR), per-triangle IOR and dispersion
against the JAX package and the numpy oracle, on the CPU: the GGX
sampling functions and BRDF on the same numpy inputs (rtol 1e-5, atol
1e-6), the cases of test_ggx, test_rough_glass, test_ior and
test_dispersion that need no MIS, Sobol, fog, sharding or environment
map (all still unported), the shade stage on one queue with each
material (RNG draws and hit ids exact, outputs within 1e-4), and the
oracle cases at the reference's Monte-Carlo tolerance
(test_render_golden.compare)."""

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tyrant_tpu import render as jr
from tyrant_tpu import sky as jsky
from tyrant_tpu.ops import sampling as js
from tyrant_tpu.scene.scene import Scene as JScene
from tyrant_tpu.scene.scene import Spheres as JSpheres
from tyrant_tpu_torch import render as tr
from tyrant_tpu_torch import sky as tsky
from tyrant_tpu_torch.camera import Camera
from tyrant_tpu_torch.config import small_config
from tyrant_tpu_torch.ops import sampling as ts
from tyrant_tpu_torch.ops.kernels.traverse import PacketTables
from tyrant_tpu_torch.scene.description import load_description
from tyrant_tpu_torch.scene.instancing import MeshAsset, translate
from tyrant_tpu_torch.scene.scene import (GGX, REFR, RREFR, SPEC, Scene,
                                          Spheres)

from . import oracle
from .test_render_golden import SUN_POS, H, W, compare, run_oracle

CLOSE = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The renders here run for seconds on the CPU; beside the other test
    workers, PyTorch's default of a thread a core oversubscribes the
    machine many times over, so each test runs on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _unit(r, n, up=False):
    v = r.normal(size=(n, 3))
    if up:
        v[:, 2] = np.abs(v[:, 2]) + 0.05
    return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)


# --------------------------------------------------------------------------
# the GGX functions against tyrant_tpu/ops/sampling.py
# --------------------------------------------------------------------------

def test_ggx_functions_match_jax():
    r = np.random.default_rng(3)
    n = 4096
    view, normal = _unit(r, n, up=True), _unit(r, n)
    h = _unit(r, n)
    alpha = r.uniform(0.0009, 1.0, n).astype(np.float32)
    cos = r.uniform(-0.2, 1.0, n).astype(np.float32)
    u1, u2 = (r.uniform(size=n).astype(np.float32) for _ in range(2))
    for name, args in (("ggx_d", (cos, alpha)),
                       ("ggx_d_vec", (normal, h, alpha)),
                       ("ggx_g1", (cos, alpha)),
                       ("ggx_vndf_sample_from_uniforms",
                        (view, np.broadcast_to([0, 0, 1], (n, 3)), alpha,
                         u1, u2))):
        want = np.asarray(getattr(js, name)(*(jnp.asarray(a, jnp.float32)
                                                for a in args)))
        got = getattr(ts, name)(*(_t(a) for a in args)).numpy()
        np.testing.assert_allclose(got, want, err_msg=name, **CLOSE)
    f0 = r.uniform(0, 1, (n, 3)).astype(np.float32)
    ldir = _unit(r, n, up=True)
    np.testing.assert_allclose(
        tr._ggx_eval(_t(np.broadcast_to([0, 0, 1], (n, 3))), _t(view),
                     _t(ldir), _t(alpha), _t(f0)).numpy(),
        np.asarray(jr._ggx_eval(jnp.asarray(np.broadcast_to([0., 0, 1],
                                                            (n, 3))),
                                jnp.asarray(view), jnp.asarray(ldir),
                                jnp.asarray(alpha), jnp.asarray(f0))),
        rtol=1e-4, atol=1e-6)


def _albedo_mc(rough, cos_v, n=1 << 17, seed=0):
    """MC directional albedo with the port's VNDF sampler: E[G1(l)]."""
    alpha = rough * rough
    r = np.random.default_rng(seed)
    u = torch.from_numpy(r.uniform(size=(2, n)).astype(np.float32))
    normal = torch.tensor([0.0, 0.0, 1.0]).expand(n, 3)
    sin_v = float(np.sqrt(max(1.0 - cos_v * cos_v, 0.0)))
    view = torch.tensor([sin_v, 0.0, cos_v]).expand(n, 3)
    h = ts.ggx_vndf_sample_from_uniforms(view, normal,
                                         torch.full((n,), alpha), u[0], u[1])
    nl = ts.reflect(-view, h)[:, 2]
    return float(torch.where(nl > 0, ts.ggx_g1(nl, alpha),
                             torch.zeros_like(nl)).mean())


def _albedo_quad(rough, cos_v, n_theta=400, n_phi=400):
    """Numerical hemisphere integral of the oracle's f(v, l) cos(l)."""
    alpha = rough * rough
    sin_v = np.sqrt(max(1.0 - cos_v * cos_v, 0.0))
    th = (np.arange(n_theta) + 0.5) / n_theta * (np.pi / 2)
    ph = (np.arange(n_phi) + 0.5) / n_phi * (2 * np.pi)
    tt, pp = np.meshgrid(th, ph, indexing="ij")
    ldir = np.stack([np.sin(tt) * np.cos(pp), np.sin(tt) * np.sin(pp),
                     np.cos(tt)], -1).reshape(-1, 3)
    f = oracle.ggx_eval_np(np.broadcast_to([0.0, 0.0, 1.0], ldir.shape),
                           np.broadcast_to([sin_v, 0.0, cos_v], ldir.shape),
                           ldir, np.full(ldir.shape[0], alpha),
                           np.ones_like(ldir))[:, 0]
    w = f * np.cos(tt).ravel() * np.sin(tt).ravel()
    return float(w.sum() * (np.pi / 2 / n_theta) * (2 * np.pi / n_phi))


@pytest.mark.parametrize("rough", [0.2, 0.5, 0.9])
@pytest.mark.parametrize("cos_v", [0.95, 0.7, 0.3])
def test_vndf_estimator_matches_brdf_integral(rough, cos_v):
    mc, quad = _albedo_mc(rough, cos_v), _albedo_quad(rough, cos_v)
    assert abs(mc - quad) < 0.02 * max(quad, 0.1), (mc, quad)


@pytest.mark.parametrize("rough", [0.1, 0.4, 1.0])
def test_ggx_energy_bounded(rough):
    for cos_v in (0.98, 0.6, 0.2):
        assert _albedo_mc(rough, cos_v) <= 1.0 + 1e-3


def test_vndf_numpy_mirror_matches_port():
    r = np.random.default_rng(3)
    n = 4096
    view = _unit(r, n, up=True).astype(np.float64)
    normal = np.broadcast_to([0.0, 0.0, 1.0], (n, 3)).copy()
    alpha, u1, u2 = r.uniform(0.01, 1.0, n), r.uniform(size=n), \
        r.uniform(size=n)
    h_np = oracle.ggx_vndf_sample_np(view, normal, alpha, u1, u2)
    h_t = ts.ggx_vndf_sample_from_uniforms(*(_t(a) for a in (
        view, normal, alpha, u1, u2))).numpy()
    assert np.abs(h_np - h_t).max() < 1e-4
    assert (np.sum(h_np * view, -1) > 0).all()


def test_ggx_d_normalisation():
    for alpha in (0.04, 0.25, 1.0):
        n_t = 2048
        th = (np.arange(n_t) + 0.5) / n_t * (np.pi / 2)
        d = ts.ggx_d(torch.from_numpy(np.cos(th)), alpha).numpy()
        val = (d * np.cos(th) * np.sin(th)).sum() * (np.pi / 2 / n_t) \
            * 2 * np.pi
        assert abs(val - 1.0) < 2e-3, (alpha, val)


# --------------------------------------------------------------------------
# scene plumbing
# --------------------------------------------------------------------------

def _spheres(cls, refl_at, refl, rough=0.4, color=None):
    """The default seven with sphere ``refl_at`` re-typed (and coloured)."""
    s = cls.default_seven()
    r, c = s.refl.copy(), s.color.copy()
    r[refl_at] = refl
    if color is not None:
        c[refl_at] = color
    return cls(center=s.center, radius=s.radius, color=c,
               emission=s.emission, refl=r,
               roughness=np.full(s.count, rough, np.float32))


def test_scene_plumbing_and_static_flag():
    assert Scene.load(None).to_device("cpu").has_ggx is False
    sd = Scene.load(None, spheres=_spheres(Spheres, 3, GGX)).to_device("cpu")
    assert sd.has_ggx is True and not sd.has_rrefr
    tbl = sd.sphere_table.numpy()
    assert np.allclose(tbl[:, 11], 0.4, atol=1e-6) and tbl[3, 10] == GGX
    assert Scene.load(None, spheres=_spheres(Spheres, 3, GGX, rough=0.0)) \
        .to_device("cpu").sphere_table[:, 11].min() >= 0.03
    assert Scene.load(None, spheres=_spheres(Spheres, 1, RREFR)) \
        .to_device("cpu").has_rrefr


def test_obj_mtl_metallic_loads_ggx(tmp_path):
    (tmp_path / "m.mtl").write_text(
        "newmtl gold\nKd 1.0 0.77 0.34\nPr 0.22\nPm 1.0\n"
        "newmtl matte\nKd 0.5 0.5 0.5\n")
    (tmp_path / "s.obj").write_text(
        "mtllib m.mtl\nv 0 0 0\nv 1 0 0\nv 0 1 0\nv 1 1 0\n"
        "usemtl gold\nf 1 2 3\nusemtl matte\nf 2 4 3\n")
    sc = Scene.load(str(tmp_path / "s.obj"), builder="numpy")
    assert sc.tri_refl[0] == GGX and sc.tri_refl[1] == 0
    assert abs(sc.tri_rough[0] - 0.22) < 1e-6
    sd = sc.to_device("cpu")
    assert sd.has_ggx is True
    ts_ = sd.tri_shade.numpy()
    assert (ts_[ts_[:, 3] == GGX, 7] > 0.2).all()


def test_instancing_carries_roughness():
    quad = MeshAsset(v0=np.array([[0, 0, 0]], np.float32),
                     v1=np.array([[1, 0, 0]], np.float32),
                     v2=np.array([[0, 1, 0]], np.float32),
                     tri_refl=np.array([GGX], np.int32),
                     tri_rough=np.array([0.15], np.float32))
    sc = Scene.from_instances([quad], [(0, translate((0, 0, 0))),
                                       (0, translate((5, 0, 0)))],
                              builder="numpy")
    assert sc.tri_rough.shape == (2,) and np.allclose(sc.tri_rough, 0.15)
    assert sc.to_device("cpu").has_ggx is True


def test_json_rough_glass_and_ior(tmp_path):
    (tmp_path / "frosted.json").write_text(json.dumps({
        "spheres": [{"center": [0, 0, 5], "radius": 2,
                     "material": "rough_glass", "roughness": 0.35},
                    {"center": [0, 0, 100], "radius": 5,
                     "material": "light", "emission": [4, 4, 4]}],
        "default_spheres": False}))
    sc = load_description(str(tmp_path / "frosted.json")).scene
    i = int(np.nonzero(sc.spheres.refl == RREFR)[0][0])
    assert sc.spheres.roughness[i] == np.float32(0.35)
    assert sc.to_device("cpu").has_rrefr
    (tmp_path / "tri.ply").write_text(
        "ply\nformat ascii 1.0\nelement vertex 3\n"
        "property float x\nproperty float y\nproperty float z\n"
        "element face 1\nproperty list uchar int vertex_indices\n"
        "end_header\n0 0 0\n1 0 0\n0 1 0\n3 0 1 2\n")
    (tmp_path / "s.json").write_text(json.dumps({
        "meshes": [{"path": "tri.ply", "material": "glass", "ior": 1.55}],
        "default_spheres": False}))
    sc = load_description(str(tmp_path / "s.json")).scene
    assert sc.tri_refl[0] == REFR
    np.testing.assert_allclose(sc.tri_ior[0], 1.55)
    sd = sc.to_device("cpu")
    assert sd.has_var_ior
    assert sd.tri_shade[0, 7].item() == np.float32(1.55)


# QV0/QV1/QV2 of test_normal_map: a 60 x 60 quad at z = 0 facing +z
QV0 = np.array([[-30, -30, 0], [30, 30, 0]], np.float32)
QV1 = np.array([[30, -30, 0], [-30, 30, 0]], np.float32)
QV2 = np.array([[30, 30, 0], [-30, -30, 0]], np.float32)


def _glass_over_black(ior):
    """test_ior's glass quad, lit by the sky instead of an environment
    map: a normal-incidence camera ray reflects to the sky with
    probability r0(eta) and otherwise transmits onto a black floor."""
    v0 = np.concatenate([QV0, QV0 - [0, 0, 5]])
    v1 = np.concatenate([QV1, QV1 - [0, 0, 5]])
    v2 = np.concatenate([QV2, QV2 - [0, 0, 5]])
    s = Spheres.default_seven()
    keep = np.arange(7) == 6  # the far light alone
    return Scene.from_triangles(
        v0, v1, v2, builder="numpy",
        spheres=Spheres(center=s.center[keep], radius=s.radius[keep],
                        color=s.color[keep], emission=s.emission[keep],
                        refl=s.refl[keep]),
        tri_refl=np.array([REFR, REFR, 0, 0], np.int32),
        tri_color=np.array([[0.0] * 3] * 4, np.float32),
        tri_ior=None if ior is None else np.full(4, ior, np.float32))


def _down_camera(z=40.0):
    cam = Camera()
    cam.position = np.array([0.0, 0.0, z], np.float32)
    cam.vertical_angle = -np.pi / 2 + 1e-3
    return cam


def test_ior_lane_encoding():
    sd = _glass_over_black(2.4).to_device("cpu")
    assert sd.has_var_ior
    ts_ = sd.tri_shade.numpy()
    assert (ts_[ts_[:, 3] == REFR, 7] == np.float32(2.4)).all()
    assert not _glass_over_black(1.2).to_device("cpu").has_var_ior
    assert not _glass_over_black(None).to_device("cpu").has_var_ior


def test_ior_default_is_bitwise_reference():
    """tri_ior = 1.2 changes no bit against no tri_ior at all."""
    cfg = small_config(width=32, height=32, num_rays=1 << 11)
    out = []
    for ior in (None, 1.2):
        r = tr.Renderer(_glass_over_black(ior), cfg, device="cpu")
        r.step(_down_camera(), 6)
        out.append(r.state.accum.numpy())
    np.testing.assert_array_equal(out[0], out[1])


def test_ior_drives_fresnel_reflectance():
    """r0 = ((eta - 1) / (eta + 1))^2: IOR 2.4 reflects about 20x more
    than 1.2, and the quad's centre can only be lit by reflections."""
    cfg = small_config(width=32, height=32, num_rays=1 << 12)

    def lum(ior):
        r = tr.Renderer(_glass_over_black(ior), cfg, device="cpu")
        r.step(_down_camera(), 24)
        a = r.state.accum.numpy()
        img = (a[:, :3].mean(1) / np.maximum(a[:, 3], 1)).reshape(32, 32)
        return img[12:20, 12:20].mean()

    hi, lo = lum(2.4), lum(1.2)
    assert hi > 4.0 * lo, (hi, lo)


# --------------------------------------------------------------------------
# renders
# --------------------------------------------------------------------------

def _cluster_camera():
    cam = Camera()
    cam.position = np.array([0.0, -170.0, 40.0], np.float32)
    cam.vertical_angle = -0.10
    return cam


def _render(scene, cfg, steps, cam=None):
    r = tr.Renderer(scene, cfg, device="cpu", sun_position=SUN_POS)
    r.step(cam or _cluster_camera(), steps)
    return r.state.accum.numpy()


def test_ggx_triangles_render_finite():
    v0 = np.array([[-30, -90, 60], [30, -70, 60]], np.float32)
    v1 = np.array([[30, -90, 60], [-30, -90, 60]], np.float32)
    v2 = np.array([[30, -70, 60], [-30, -70, 60]], np.float32)
    sc = Scene.from_triangles(
        v0, v1, v2, builder="numpy", tri_refl=np.full(2, GGX, np.int32),
        tri_color=np.full((2, 3), 0.9, np.float32),
        tri_rough=np.full(2, 0.25, np.float32))
    assert sc.to_device("cpu").has_ggx
    cam = _cluster_camera()
    cam.vertical_angle = 0.15
    acc = _render(sc, small_config(width=W, height=H, num_rays=1 << 12), 6,
                  cam)
    assert np.isfinite(acc).all() and (acc[:, 3] > 0).all()


def _glass_view(refl, rough):
    cam = Camera()
    cam.position = np.array([40.0, -90.0, 30.0], np.float32)
    cam.look_at([40.0, 0.0, 16.5])
    r = tr.Renderer(Scene.load(None, spheres=_spheres(Spheres, 1, refl,
                                                      rough=rough)),
                    small_config(width=48, height=32, num_rays=2048),
                    device="cpu")
    r.step(cam, 24)
    return r.radiance().numpy()


def test_smooth_limit_matches_refr():
    """RREFR at roughness 0.03 reproduces smooth REFR's mean (the same
    reflect/transmit coin); per pixel only gross structure agrees."""
    a, b = _glass_view(REFR, 0.3), _glass_view(RREFR, 0.03)
    assert np.isfinite(b).all()
    assert abs(a.mean() - b.mean()) / a.mean() < 0.05
    assert np.mean(np.abs(a - b)) / a.mean() < 0.25


def test_roughness_spreads_without_creating_energy():
    a, b = _glass_view(REFR, 0.3), _glass_view(RREFR, 0.4)
    assert np.isfinite(b).all()
    assert abs(a.mean() - b.mean()) / a.mean() < 0.06
    assert np.abs(a - b).max() > 0.05


def test_dispersion_config_validation():
    with pytest.raises(ValueError):
        small_config(dispersion=-0.1)
    with pytest.raises(ValueError):
        small_config(dispersion=0.9)
    assert small_config(dispersion=0.1).dispersion == 0.1


def test_tiny_dispersion_preserves_mean_radiance():
    """The wavelength collapse is unbiased: a vanishing IOR spread keeps
    the image's expectation."""
    base = small_config(width=W, height=H, num_rays=1 << 14)
    compare(_render(Scene.load(None), base, 40),
            _render(Scene.load(None), dataclasses.replace(
                base, dispersion=1e-6), 40))


def test_dispersion_changes_glass_pixels_only():
    from tyrant_tpu_torch.ops.tonemap import resolve
    base = small_config(width=W, height=H, num_rays=1 << 14)
    img_a = resolve(torch.from_numpy(_render(Scene.load(None), base, 40)),
                    W, H).numpy()
    img_b = resolve(torch.from_numpy(_render(
        Scene.load(None), dataclasses.replace(base, dispersion=0.15), 40)),
        W, H).numpy()
    diff = np.abs(img_a - img_b).max(-1)
    assert diff.max() > 0.04, diff.max()
    assert np.median(diff) < 0.02, np.median(diff)


def _oracle_rows(s):
    return [(s.radius[i], s.center[i], s.color[i], s.emission[i], s.refl[i])
            for i in range(s.count)]


def test_ggx_sphere_scene_matches_oracle():
    """test_ggx's oracle case: the SPEC sphere as a gold GGX conductor."""
    sp = _spheres(Spheres, 3, GGX, color=(1.0, 0.77, 0.34))
    acc = _render(Scene.load(None, spheres=sp),
                  small_config(width=W, height=H, num_rays=1 << 14), 60)
    cam = _cluster_camera()
    acc_or = run_oracle(oracle.OracleScene(_oracle_rows(sp), light_index=6,
                                           roughness=sp.roughness),
                        cam, 1500, small_config(width=W, height=H))
    compare(acc, acc_or)


def test_dispersion_matches_oracle():
    """test_dispersion's oracle case: dispersion 0.15 on the seven
    spheres, against the oracle's own wavelength collapse."""
    cfg = small_config(width=W, height=H, num_rays=1 << 14, dispersion=0.15)
    acc = _render(Scene.load(None), cfg, 60)
    s = Spheres.default_seven()
    acc_or = run_oracle(oracle.OracleScene(_oracle_rows(s), light_index=6),
                        _cluster_camera(), 1500, cfg, dispersion=0.15)
    compare(acc, acc_or)


# --------------------------------------------------------------------------
# shade with each material, from the same queue as the JAX package
# --------------------------------------------------------------------------

def _material_scene(scene_cls, spheres_cls, case):
    """A terrain with random DIFF/SPEC/REFR/PHONG/GGX/RREFR triangles,
    roughness and (``ior``) glass IOR, under the seven spheres with a GGX
    and an RREFR one; ``bare``: the terrain alone, no sphere."""
    from tyrant_tpu_torch.scene.procgen import terrain
    v0, v1, v2 = terrain(n_quads=16, towers=2)
    t = v0.shape[0]
    r = np.random.default_rng(4)
    refl = r.choice([0, 1, 2, 3, GGX, RREFR], t).astype(np.int32)
    kw = dict(tri_refl=refl,
              tri_color=r.uniform(0.2, 1.0, (t, 3)).astype(np.float32),
              tri_rough=r.uniform(0.0, 1.0, t).astype(np.float32))
    if case == "ior":
        kw["tri_ior"] = r.uniform(1.3, 2.0, t).astype(np.float32)
    sp = _spheres(spheres_cls, 3, GGX)
    sp.refl[1] = RREFR
    if case == "bare":
        empty = np.zeros((0, 3), np.float32)
        sp = spheres_cls(center=empty, radius=np.zeros(0, np.float32),
                         color=empty, emission=empty,
                         refl=np.zeros(0, np.int32))
    return scene_cls.from_triangles(v0, v1, v2, spheres=sp, builder="numpy",
                                    **kw)


@pytest.mark.parametrize("case,dispersion", [("materials", 0.0),
                                             ("ior", 0.05), ("bare", 0.0)])
def test_shade_matches_jax_per_material(case, dispersion):
    """One queue (the JAX package's step-4 queue on this scene) through
    both packages' extend and shade: hit ids exact, Russian roulette and
    the NEE choice equal on >= 99.9% of slots, outputs within 1e-4 where
    they agree."""
    cfg = small_config(width=32, height=32, num_rays=4096,
                       dispersion=dispersion)
    js_ = _material_scene(JScene, JSpheres, case)
    tsc = _material_scene(Scene, Spheres, case)
    jd, td = js_.to_device(), tsc.to_device("cpu")
    assert td.n_spheres == (0 if case == "bare" else 7)
    cam = _cluster_camera()
    cam.position = np.array([0.0, -140.0, 40.0], np.float32)
    cam.vertical_angle = -0.2
    from tyrant_tpu.camera import Camera as JCamera
    jcam = JCamera()
    jcam.position, jcam.vertical_angle = cam.position, cam.vertical_angle
    jsun = jsky.sun_direction_from_position(jnp.asarray(SUN_POS))
    st = jr.init_state(cfg)
    for _ in range(4):
        st = jr.render_step(st, jd, jcam.to_device(cfg), jsun, cfg=cfg)
    gen = jr._raygen(cfg, jcam.to_device(cfg), st.start_position, st.frame,
                     cfg.height, 0)
    keep = np.arange(cfg.num_rays) >= cfg.num_rays - int(st.n_carried)
    rays = {k: np.where(keep[:, None] if np.ndim(gen[k]) == 2 else keep,
                        np.asarray(getattr(st, k)), np.asarray(gen[k]))
            for k in ("origin", "direction", "direct", "pending", "pixel",
                      "bounces", "last_specular")}
    jt, jid, jtri, _ = jr._intersect_scene(jnp.asarray(rays["origin"]),
                                           jnp.asarray(rays["direction"]), jd)
    trays = {k: torch.from_numpy(np.array(v)) for k, v in rays.items()}
    tt, tid, ttri = tr._intersect_scene(trays["origin"], trays["direction"],
                                        td, PacketTables(td.bvh))
    np.testing.assert_array_equal(tid.numpy(), np.asarray(jid))
    frame = int(st.frame)
    jc, _, jsurv, jnext, jshadow = jr._shade(
        cfg, jd, jsky.SkyParams(cfg.sky), jsun,
        {k: jnp.asarray(v) for k, v in rays.items()}, jt, jid, jtri,
        jnp.uint32(frame))
    tc, tsurv, tnext, tshadow = tr._shade(
        cfg, td, tsky.SkyParams(cfg.sky),
        tsky.sun_direction_from_position(SUN_POS, "cpu"), trays,
        torch.from_numpy(np.array(jt)), torch.from_numpy(np.array(jid)),
        torch.from_numpy(np.array(jtri)), torch.tensor(frame))
    refl = td.tri_shade[tid.clamp(min=0).long(), 3].numpy()
    hit_tri = np.asarray(jtri)
    for m in ({"materials": (GGX, RREFR), "ior": (REFR,),
               "bare": (GGX, RREFR, REFR)}[case]):
        assert (hit_tri & (refl == m)).sum() > 20, m
    ok = (tsurv.numpy() == np.asarray(jsurv)) \
        & (tshadow["valid"].numpy() == np.asarray(jshadow["valid"]))
    assert ok.mean() >= 0.999, ok.mean()
    close = dict(rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tc.numpy()[ok], np.asarray(jc)[ok], **close)
    for k in ("origin", "direction", "direct"):
        np.testing.assert_allclose(tnext[k].numpy()[ok],
                                   np.asarray(jnext[k])[ok], err_msg=k,
                                   **close)
    np.testing.assert_array_equal(tnext["last_specular"].numpy(),
                                  np.asarray(jnext["last_specular"]))
    for k in ("direction", "color", "max_dist"):
        np.testing.assert_allclose(tshadow[k].numpy()[ok],
                                   np.asarray(jshadow[k])[ok], err_msg=k,
                                   **close)
