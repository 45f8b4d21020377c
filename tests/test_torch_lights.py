"""The lights on the CPU against the JAX package: several emissive
spheres, emissive triangles, point/spot/directional delta lights and the
uniform and power light picks (the CDF up to 64 lights, the alias rows
beyond).

- The host tables bit for bit: ``DeltaLights.pack``, ``tri_lights``,
  ``light_powers``, ``light_alias`` and ``tri_shade`` lane 7 (a LIGHT
  triangle's area), through test_torch_loaders.check_tables.
- The power pick's CDF, inverse pdfs and total within 2 ulp of the ones
  the JAX shade traces (XLA's sum and scan add in another order than
  PyTorch's); so a pick may differ only where the uniform lies within 2
  ulp of a CDF entry (a tie): ties are counted, at most 2 allowed.
- ``_shade`` against the JAX ``_shade`` on one queue of each light kind:
  the light picks (ties counted), hit ids, ``shadow.valid``, Russian
  roulette and the next rays' integer fields and last_specular exact;
  the shadow max distances within 2 ulp (XLA fuses the distance's dot
  product); colours, directions, throughputs and MIS pdfs within rtol
  1e-4, atol 1e-4.
- The estimator checks of test_tri_lights, test_delta_lights and
  test_light_power that do not need the orthographic camera, with the
  perspective camera looking straight down, against quadrature or the
  analytic radiometry."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tyrant_tpu import render as jr
from tyrant_tpu import sky as jsky
from tyrant_tpu.scene.scene import DeltaLights as JDeltaLights
from tyrant_tpu.scene.scene import Scene as JScene
from tyrant_tpu.scene.scene import Spheres as JSpheres
from tyrant_tpu_torch import render as tr
from tyrant_tpu_torch import sky as tsky
from tyrant_tpu_torch.camera import Camera
from tyrant_tpu_torch.config import INV_PI, small_config
from tyrant_tpu_torch.ops.kernels.traverse import PacketTables
from tyrant_tpu_torch.scene.procgen import terrain
from tyrant_tpu_torch.scene.scene import (DIFF, DL_POINT, DL_SPOT, LIGHT,
                                          DeltaLights, Scene, Spheres)

from .test_torch_loaders import check_tables

SUN = (0.05, 0.3)
CLOSE = dict(rtol=1e-4, atol=1e-4)
DELTA_SPECS = [
    {"type": "point", "position": [20.0, -40.0, 60.0],
     "intensity": [900.0, 800.0, 700.0]},
    {"type": "spot", "position": [-30.0, -60.0, 70.0],
     "direction": [0.2, 0.3, -1.0], "intensity": [2000.0, 1500.0, 1000.0],
     "inner_deg": 15.0, "outer_deg": 35.0},
    {"type": "directional", "direction": [0.3, 0.2, -1.0],
     "intensity": [0.6, 0.6, 0.5]}]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One PyTorch thread: beside the other test workers the default of a
    thread a core oversubscribes the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bits(a):
    a = np.ascontiguousarray(np.asarray(a))
    return a.view(np.uint32) if a.dtype == np.float32 else a


# --------------------------------------------------------------------------
# scenes
# --------------------------------------------------------------------------

def _spheres(cls, n_lights=3):
    """The default seven with ``n_lights`` emissive: sphere 6's own light
    first, then the DIFF sphere 0 and the red sphere 5."""
    s = cls.default_seven()
    refl, em = s.refl.copy(), s.emission.copy()
    for i, e in zip((0, 5)[:n_lights - 1], ((2.0, 1.5, 1.0), (0.5, 0.2, 4.0))):
        refl[i] = LIGHT
        em[i] = e
    return cls(center=s.center, radius=s.radius, color=s.color,
               emission=em, refl=refl)


def light_scene(cls, spheres_cls, dl_cls, n_sphere_lights=1, n_tri=0,
                delta=False, envmap=None, n_quads=16):
    """A small terrain under the seven spheres: ``n_sphere_lights`` of
    them emissive, ``n_tri`` triangles made LIGHT with a stride through
    the triangle list (emission of a few units), the three delta lights
    of DELTA_SPECS, an envmap."""
    v0, v1, v2 = terrain(n_quads=n_quads, towers=2)
    kw = {}
    if n_tri:
        t = v0.shape[0]
        refl = np.zeros(t, np.int32)
        color = np.full((t, 3), 0.8, np.float32)
        lit = np.arange(n_tri) * (t // n_tri)
        refl[lit] = LIGHT
        color[lit] = np.stack([2.0 + (lit % 3), 3.0 - (lit % 2),
                               1.0 + (lit % 5) * 0.5], 1)
        kw.update(tri_refl=refl, tri_color=color)
    if delta:
        kw["delta_lights"] = dl_cls.from_specs(DELTA_SPECS)
    if envmap is not None:
        kw["envmap"] = envmap
    return cls.from_triangles(v0, v1, v2, builder="numpy",
                              spheres=_spheres(spheres_cls, n_sphere_lights),
                              **kw)


def hot_envmap(h=16, w=32, seed=4):
    """A dim random map with one bright patch above the horizon."""
    em = np.random.default_rng(seed).uniform(0.02, 0.3, (h, w, 3))
    em[h // 4, w // 3] = (40.0, 36.0, 30.0)
    return em.astype(np.float32)


def both(**kw):
    """(JAX Scene, port Scene) of :func:`light_scene`."""
    return (light_scene(JScene, JSpheres, JDeltaLights, **kw),
            light_scene(Scene, Spheres, DeltaLights, **kw))


def pose(cls=Camera):
    cam = cls()
    cam.position = np.array([0.0, -140.0, 40.0], np.float32)
    cam.vertical_angle = -0.2
    return cam


# --------------------------------------------------------------------------
# host tables
# --------------------------------------------------------------------------

def test_delta_lights_pack_bitwise():
    specs = DELTA_SPECS + [{"type": "spot", "position": [0, 0, 9],
                            "direction": [0, 0, -2], "outer_deg": 30}]
    np.testing.assert_array_equal(
        _bits(DeltaLights.from_specs(specs).pack()),
        _bits(JDeltaLights.from_specs(specs).pack()))


@pytest.mark.parametrize("case", ["spheres", "tri_delta", "alias", "env"])
def test_light_tables_bitwise(case):
    kw = dict(spheres=dict(n_sphere_lights=3),
              tri_delta=dict(n_sphere_lights=3, n_tri=20, delta=True),
              alias=dict(n_sphere_lights=3, n_tri=80, delta=True),
              env=dict(n_tri=4, envmap=hot_envmap()))[case]
    js, ts = both(**kw)
    jd, td = js.to_device(), ts.to_device("cpu")
    check_tables(jd, td)
    if case == "alias":
        assert td.light_alias.shape == (86, 4)
    # the JAX SceneData carried over as numpy (interop) is the same scene
    from tyrant_tpu.ops.pallas.traverse_kernel import PacketTables as JPT

    from tyrant_tpu_torch import interop
    leaves = {k: np.asarray(getattr(jd.bvh, k))
              for k in interop.SCENE_LEAVES[:4]}
    leaves.update({k: np.asarray(getattr(jd, k))
                   for k in interop.SCENE_LEAVES[4:]})
    carried, _ = interop.scene_from_numpy(
        leaves, np.asarray(JPT(jd.bvh).rows), "cpu",
        flags={k: getattr(jd, k) for k in interop.SCENE_FLAGS},
        aux={k: getattr(jd, k) for k in interop.SCENE_AUX})
    check_tables(jd, carried)


def _jax_pick_tables(pw):
    """The JAX shade's power pick arrays (tyrant_tpu/render.py:1171-1182),
    traced as the step traces them."""
    import jax

    n_l = pw.shape[0]

    @jax.jit
    def f(pw):
        tp = jnp.sum(pw)
        pdfs = jnp.where(tp > 0, 0.75 * pw / jnp.maximum(tp, 1e-30)
                         + 0.25 / n_l, jnp.full_like(pw, 1.0 / n_l))
        return jnp.cumsum(pdfs), 1.0 / jnp.maximum(pdfs, 1e-30), tp
    return [np.asarray(a) for a in f(pw)]


@pytest.mark.parametrize("n_tri", [0, 20, 57])
def test_power_cdf_within_2_ulp(n_tri):
    js, ts = both(n_sphere_lights=3, n_tri=n_tri, delta=bool(n_tri))
    jd, td = js.to_device(), ts.to_device("cpu")
    cdf, inv, tp = _jax_pick_tables(np.asarray(jd.light_powers))
    for got, want in ((td.light_cdf, cdf), (td.light_inv_pdf, inv),
                      (td.light_total_power, tp)):
        got = got.numpy()
        assert np.all(np.abs(got - want) <= 2 * np.spacing(np.abs(want))), \
            (got, want)


# --------------------------------------------------------------------------
# _shade against the JAX _shade
# --------------------------------------------------------------------------

SHADE_CASES = {
    "spheres_uniform": (dict(n_sphere_lights=3), {}),
    "power_cdf": (dict(n_sphere_lights=3, n_tri=20, delta=True),
                  dict(light_sampling="power")),
    "power_alias": (dict(n_sphere_lights=3, n_tri=80, delta=True),
                    dict(light_sampling="power")),
    "tri_lights": (dict(n_tri=24), {}),
    "delta": (dict(delta=True), {}),
    "env_mis_off": (dict(envmap=hot_envmap()), {}),
    "env_mis_on": (dict(envmap=hot_envmap()), dict(mis="on")),
    "mis_area": (dict(n_sphere_lights=3, n_tri=20),
                 dict(mis="on", light_sampling="power")),
}


def queue_and_shade(js, ts, cfg, steps=4):
    """A step queue of the port's Renderer after ``steps`` steps at
    :func:`pose`, extended and shaded by both packages.  Returns
    (port outputs, JAX outputs, the hit ids, the port scene, rays)."""
    tren = tr.Renderer(ts, cfg, device="cpu", sun_position=SUN)
    tren.step(pose(), steps)
    td = tren.scene
    rays = tr.merge_queue(cfg, tren.state, tren._last_cam)
    t, ident, is_tri = tr._intersect_scene(rays["origin"], rays["direction"],
                                           td, tren.tables)
    jd = js.to_device()
    jrays = {k: jnp.asarray(v.numpy()) for k, v in rays.items()}
    jt, jid, jtri, _ = jr._intersect_scene(jrays["origin"],
                                           jrays["direction"], jd)
    np.testing.assert_array_equal(ident.numpy(), np.asarray(jid))
    frame = int(tren.state.frame)
    jc, _, jsurv, jnext, jshadow = jr._shade(
        cfg, jd, jsky.SkyParams(cfg.sky),
        jsky.sun_direction_from_position(jnp.asarray(SUN)), jrays,
        jt, jid, jtri, jnp.uint32(frame))
    out = tr._shade(cfg, td, tsky.SkyParams(cfg.sky), tren.sun_dir, rays,
                    torch.from_numpy(np.array(jt)),
                    torch.from_numpy(np.array(jid)),
                    torch.from_numpy(np.array(jtri)), torch.tensor(frame))
    return dict(port=out, jax=(jc, jsurv, jnext, jshadow),
                ident=ident.numpy(), td=td, jd=jd, rays=rays, frame=frame)


def nee_picks(cfg, jd, td, rays, frame, n):
    """The light pick of both packages' NEE sampling on the queue's
    pixels and slots (the pick reads no geometry: any o and normal do),
    and the rays whose uniform lies within 2 ulp of a CDF entry."""
    o = np.zeros((n, 3), np.float32)
    nrm = np.tile(np.float32([0.0, 0.0, 1.0]), (n, 1))
    slot = np.arange(n)
    jout = jr._shade_nee_samples(
        cfg, jd, jsky.SkyParams(cfg.sky),
        jsky.sun_direction_from_position(jnp.asarray(SUN)),
        {k: jnp.asarray(v.numpy()) for k, v in rays.items()},
        jnp.asarray(o), jnp.asarray(nrm), jnp.uint32(frame),
        jnp.asarray(slot, jnp.int32), 0,
        jr.rng.seed_from(jnp.uint32(frame), jnp.asarray(rays["pixel"]),
                         jnp.asarray(slot, jnp.int32), 0, 0x5ADE),
        False, None, None, cfg.mis == "on")
    tout = tr._shade_nee_samples(
        cfg, td, tsky.SkyParams(cfg.sky),
        tsky.sun_direction_from_position(SUN, "cpu"), rays,
        torch.from_numpy(o), torch.from_numpy(nrm), torch.tensor(frame),
        torch.from_numpy(slot), tr.rng.seed_from(
            torch.tensor(frame), rays["pixel"], torch.from_numpy(slot), 0,
            0x5ADE))
    _, lu = tr.rng.random_float(tr.rng.seed_from(
        torch.tensor(frame), rays["pixel"], torch.from_numpy(slot), 0,
        0x11F7))
    lu = lu.numpy()
    cdf = td.light_cdf.numpy()[:-1]
    tie = (np.abs(lu[:, None] - cdf[None]) <= 2 * np.spacing(cdf)).any(1)
    return np.asarray(jout[9]), tout["pick"].numpy(), tie


@pytest.mark.parametrize("case", list(SHADE_CASES))
def test_shade_matches_jax_per_light(case):
    kw, over = SHADE_CASES[case]
    cfg = small_config(width=32, height=32, num_rays=4096, **over)
    js, ts = both(**kw)
    q = queue_and_shade(js, ts, cfg)
    tc, tsurv, tnext, tshadow = q["port"]
    jc, jsurv, jnext, jshadow = q["jax"]
    ident, td = q["ident"], q["td"]
    multi, total = tr._n_lights(td)
    if multi:
        jpick, tpick, tie = nee_picks(cfg, q["jd"], td, q["rays"],
                                      q["frame"], cfg.num_rays)
        assert tie.sum() <= 2, tie.sum()
        np.testing.assert_array_equal(tpick[~tie], jpick[~tie])
        assert np.unique(tpick).size >= min(total, 8)
    if kw.get("n_tri"):
        # triangle lights hit directly, and the shrunk shadow range
        hit_light = (ident >= 0) & (td.tri_shade[
            torch.clamp(torch.from_numpy(ident), min=0).long(), 3].numpy()
            == LIGHT)
        assert hit_light.sum() > 0
    np.testing.assert_array_equal(tsurv.numpy(), np.asarray(jsurv))
    valid = tshadow["valid"].numpy()
    np.testing.assert_array_equal(valid, np.asarray(jshadow["valid"]))
    assert valid.sum() > 100
    np.testing.assert_allclose(tshadow["max_dist"].numpy()[valid],
                               np.asarray(jshadow["max_dist"])[valid],
                               rtol=2.4e-7, atol=0)
    ok = np.ones_like(valid)
    np.testing.assert_allclose(tc.numpy()[ok], np.asarray(jc)[ok], **CLOSE)
    for k in ("origin", "direction", "direct"):
        np.testing.assert_allclose(tnext[k].numpy()[ok],
                                   np.asarray(jnext[k])[ok], err_msg=k,
                                   **CLOSE)
    for k in ("pixel", "bounces", "last_specular"):
        np.testing.assert_array_equal(tnext[k].numpy(),
                                      np.asarray(jnext[k]), err_msg=k)
    if cfg.mis == "on":
        np.testing.assert_allclose(tnext["bsdf_pdf"].numpy()[ok],
                                   np.asarray(jnext["bsdf_pdf"])[ok],
                                   **CLOSE)
    else:
        assert "bsdf_pdf" not in tnext
    for k in ("direction", "color"):
        np.testing.assert_allclose(tshadow[k].numpy()[ok],
                                   np.asarray(jshadow[k])[ok], err_msg=k,
                                   **CLOSE)


# --------------------------------------------------------------------------
# emissive triangles (test_tri_lights)
# --------------------------------------------------------------------------

def _dummy_spheres():
    """One faraway dark sphere, no sphere light."""
    return Spheres(center=np.array([[0, 0, -5e4]], np.float32),
                   radius=np.array([1.0], np.float32),
                   color=np.zeros((1, 3), np.float32),
                   emission=np.zeros((1, 3), np.float32),
                   refl=np.array([DIFF], np.int32))


def _floor_and_quad_light(light_z=60.0, half_l=20.0, emission=(4, 4, 4)):
    """A diffuse floor at z=0 and an emissive quad (2 triangles) at
    z=light_z under a black envmap: the quad is the only light, and it
    takes every NEE sample."""
    hf = 300.0
    v0 = np.array([[-hf, -hf, 0], [hf, hf, 0],
                   [-half_l, -half_l, light_z], [half_l, half_l, light_z]],
                  np.float32)
    v1 = np.array([[hf, -hf, 0], [-hf, hf, 0],
                   [half_l, -half_l, light_z], [-half_l, half_l, light_z]],
                  np.float32)
    v2 = np.array([[-hf, hf, 0], [hf, -hf, 0],
                   [-half_l, half_l, light_z], [half_l, -half_l, light_z]],
                  np.float32)
    n = np.cross(v1 - v0, v2 - v0)
    flip = n[:, 2] < 0
    v1[flip], v2[flip] = v2[flip].copy(), v1[flip].copy()
    color = np.ones((4, 3), np.float32)
    color[2:] = emission
    return Scene.from_triangles(
        v0, v1, v2, builder="numpy", spheres=_dummy_spheres(),
        tri_refl=np.array([DIFF, DIFF, LIGHT, LIGHT], np.int32),
        tri_color=color, envmap=np.zeros((4, 8, 3), np.float32))


TRI_CFG = small_config(width=16, height=16, num_rays=1 << 10)
TRI_SUN = (0.05, 0.3)


def test_tri_light_table():
    sd = _floor_and_quad_light(half_l=20.0).to_device("cpu")
    assert sd.n_tri_lights == 2 and sd.tri_lights.shape == (2, 13)
    tl = sd.tri_lights.numpy()
    np.testing.assert_allclose(tl[:, 12], 800.0, rtol=1e-5)  # half the quad
    np.testing.assert_allclose(tl[:, 9:12], 4.0)
    # tri_shade lane 7 of each LIGHT triangle is its area
    lt = sd.tri_shade[:, 3].numpy() == LIGHT
    np.testing.assert_allclose(sd.tri_shade[lt, 7].numpy(), 800.0, rtol=1e-5)


def test_direct_hit_emission():
    """Primaries (lastSpecular) that hit the quad show its emission."""
    sd = _floor_and_quad_light().to_device("cpu")
    cam = Camera()
    cam.position = np.array([0.0, 0.0, 120.0], np.float32)
    cam.vertical_angle = -1.2
    camd = cam.to_device(TRI_CFG, "cpu")
    gen = tr._raygen(TRI_CFG, camd, torch.tensor(0), torch.tensor(1))
    t, ident, is_tri = tr._intersect_scene(gen["origin"], gen["direction"],
                                           sd, PacketTables(sd.bvh))
    color, _, _, _ = tr._shade(
        TRI_CFG, sd, tsky.SkyParams(TRI_CFG.sky),
        tsky.sun_direction_from_position(TRI_SUN, "cpu"), gen, t, ident,
        is_tri, torch.tensor(1))
    col = color.numpy()
    lit = col.max(axis=1) > 3.9
    assert lit.mean() > 0.1
    np.testing.assert_allclose(col[lit], 4.0, rtol=1e-5)


def test_nee_matches_quadrature():
    """NEE from the quad onto fixed floor points (straight-down rays)
    against a numpy area quadrature of L cos_s cos_l / (pi r^2) dA, over
    200 one-sample frames."""
    sd = _floor_and_quad_light(light_z=60.0, half_l=20.0).to_device("cpu")
    tables = PacketTables(sd.bvh)
    n = TRI_CFG.num_rays
    xy = np.random.default_rng(1).uniform(-80, 80, (n, 2)).astype(np.float32)
    origin = np.concatenate([xy, np.full((n, 1), 50.0, np.float32)], axis=1)
    direction = np.tile(np.float32([[0.0, 0.0, -1.0]]), (n, 1))
    rays = dict(origin=torch.from_numpy(origin),
                direction=torch.from_numpy(direction),
                direct=torch.ones((n, 3)), pending=torch.zeros((n, 3)),
                pixel=torch.arange(n, dtype=torch.int32)
                % (TRI_CFG.width * TRI_CFG.height),
                bounces=torch.zeros((n,), dtype=torch.int32),
                last_specular=torch.zeros((n,), dtype=torch.bool))
    t, ident, is_tri = tr._intersect_scene(rays["origin"], rays["direction"],
                                           sd, tables)
    sun = tsky.sun_direction_from_position(TRI_SUN, "cpu")
    frames = 200
    acc = np.zeros((n, 3))
    for f in range(1, frames + 1):
        _, _, _, shadow = tr._shade(TRI_CFG, sd, tsky.SkyParams(TRI_CFG.sky),
                                    sun, rays, t, ident, is_tri,
                                    torch.tensor(f))
        acc += tr._connect(sd, shadow, tables).numpy()
    mean_contrib = acc / frames
    hp = origin + direction * t.numpy()[:, None]

    m = 50000
    qr = np.random.default_rng(0)
    u, v = qr.random(m), qr.random(m)
    su = np.sqrt(u)
    tl = sd.tri_lights.numpy()
    sel = [0, 5, 17, 100, 500, 900]
    want = []
    for i in sel:
        e = 0.0
        for k in range(2):
            pts = tl[k, 0:3] + (1 - su)[:, None] * tl[k, 3:6] \
                + (v * su)[:, None] * tl[k, 6:9]
            d = pts - hp[i]
            r2 = (d * d).sum(1)
            dn = d / np.sqrt(r2)[:, None]
            e += (np.where(dn[:, 2] > 0, dn[:, 2] * np.abs(dn[:, 2]) / r2,
                           0.0)).mean() * tl[k, 12]
        want.append(4.0 * e * INV_PI)
    np.testing.assert_allclose(mean_contrib[sel].mean(axis=1), want,
                               rtol=0.10, atol=2e-3)


def test_renderer_end_to_end_tri_light():
    r = tr.Renderer(_floor_and_quad_light(),
                    small_config(width=32, height=32, num_rays=1 << 12),
                    device="cpu")
    cam = Camera()
    cam.position = np.array([0.0, -120.0, 45.0], np.float32)
    cam.vertical_angle = -0.3
    r.step(cam, 4)
    img = r.image().numpy()
    assert np.isfinite(img).all() and img.max() > 0.05


def test_sphere_only_scenes_unchanged():
    sd = Scene.load(None).to_device("cpu")
    assert sd.n_tri_lights == 0 and sd.tri_lights.shape == (1, 13)
    assert sd.light_indices == (6,) and not tr._n_lights(sd)[0]


def test_obj_ke_emissive_material(tmp_path):
    (tmp_path / "m.mtl").write_text(
        "newmtl lamp\nKd 1 1 1\nKe 4 3 2\n"
        "newmtl wall\nKd 0.8 0.8 0.8\nKe 0 0 0\n")
    (tmp_path / "q.obj").write_text(
        "mtllib m.mtl\nv -5 0 30\nv 5 0 30\nv 0 5 30\n"
        "v -50 -50 0\nv 50 -50 0\nv 0 50 0\n"
        "usemtl lamp\nf 1 2 3\nusemtl wall\nf 4 5 6\n")
    scene = Scene.load(str(tmp_path / "q.obj"), builder="numpy")
    assert (scene.tri_refl == LIGHT).sum() == 1
    np.testing.assert_allclose(scene.tri_color[scene.tri_refl == LIGHT][0],
                               [4, 3, 2])
    sd = scene.to_device("cpu")
    assert sd.n_tri_lights == 1
    np.testing.assert_allclose(sd.tri_lights[0, 9:12].numpy(), [4, 3, 2],
                               rtol=1e-6)


# --------------------------------------------------------------------------
# delta lights (test_delta_lights, with a perspective camera looking
# straight down: the per-pixel ratios of renders that differ only in the
# delta light are the analytic radiometric ratios, whatever the
# projection; the RNG streams, and so the path counts, are equal).  At 70
# units a 32-pixel image spans the floor's +-52.5 in pixels of 3.3 units,
# near the JAX test's orthographic 3.1, so its jitter margins hold.
# --------------------------------------------------------------------------

ALBEDO = 0.75
CAM_Z = 70.0
DW = DH = 32


def _floor_spheres():
    return Spheres(center=np.array([[0.0, 0.0, -1e4]], np.float32),
                   radius=np.array([1e4], np.float32),
                   color=np.array([[ALBEDO] * 3], np.float32),
                   emission=np.zeros((1, 3), np.float32),
                   refl=np.array([DIFF], np.int32))


def _dcfg(mis=False, size=DW):
    # max_bounces=0: NEE at the primary vertex only (pure direct light)
    return small_config(width=size, height=size, num_rays=1 << 12,
                        max_bounces=0, mis="on" if mis else "off")


def _down_camera(z=CAM_Z):
    cam = Camera()
    cam.position = np.array([0.0, 0.0, z], np.float32)
    cam.vertical_angle = -np.pi / 2 + 1e-3
    return cam


def _drender(specs, steps=6, mis=False, spheres=None, cam_z=CAM_Z,
             size=DW):
    dl = DeltaLights.from_specs(specs) if specs else None
    scene = Scene.load(None, spheres=spheres or _floor_spheres(),
                       delta_lights=dl)
    r = tr.Renderer(scene, _dcfg(mis, size), device="cpu", sun_position=SUN)
    r.step(_down_camera(cam_z), steps)
    acc = r.state.accum.numpy()
    return (acc[:, :3] / np.maximum(acc[:, 3:4], 1e-9)).reshape(size, size,
                                                                 3)


def _pixel_world_points(ss=1, cam_z=CAM_Z, size=DW):
    """The floor (z=0) point of every (sub)pixel through the renderer's
    own primary directions; raygen's px = x - u puts pixel x's samples in
    [x-1, x]."""
    cam = _down_camera(cam_z).to_device(_dcfg(size=size), "cpu")
    w, h = size * ss, size * ss
    q = np.arange(w * h)
    ni = ((q % w) - ss + 0.5) / w - 0.5
    nj = (h - (q // w) + ss - 0.5) / h - 0.5
    d, _, _ = tr._primary_dirs(_dcfg(size=size), cam,
                               torch.from_numpy(ni.astype(np.float32)),
                               torch.from_numpy(nj.astype(np.float32)))
    d = d.numpy().astype(np.float64)
    o = cam.position.numpy().astype(np.float64)[None]
    return (o - (o[:, 2] / d[:, 2])[:, None] * d).reshape(h, w, 3)


def _block_mean(m, ss):
    return m.reshape(DH, ss, DW, ss).mean(axis=(1, 3)) if ss > 1 else m


def _point_val(pts, lpos, inten):
    lvec = np.asarray(lpos, np.float64)[None, None] - pts
    d2 = np.sum(lvec * lvec, axis=-1)
    return (ALBEDO / np.pi) * np.asarray(inten)[0] * lvec[:, :, 2] \
        / np.sqrt(d2) / d2


def test_linearity_exact():
    base = {"type": "point", "position": [0, 0, 30]}
    r0, r1, r2 = (_drender([dict(base, intensity=[i] * 3)])
                  for i in (0.0, 400.0, 800.0))
    d1, d2 = r1 - r0, r2 - r0
    assert d1.max() > 1e-3
    np.testing.assert_allclose(d2, 2.0 * d1, rtol=1e-4, atol=1e-6)


def test_point_inverse_square_and_cosine():
    base = {"type": "point", "intensity": [2000, 2000, 2000]}
    r0 = _drender([dict(base, position=[0, 0, 50], intensity=[0, 0, 0])],
                  steps=12)
    ra = _drender([dict(base, position=[0, 0, 50])], steps=12) - r0
    rb = _drender([dict(base, position=[10, 0, 100])], steps=12) - r0
    ss = 8
    pts = _pixel_world_points(ss)
    expect = _block_mean(_point_val(pts, [0, 0, 50], base["intensity"]), ss) \
        / _block_mean(_point_val(pts, [10, 0, 100], base["intensity"]), ss)
    got = ra[:, :, 0] / np.maximum(rb[:, :, 0], 1e-12)
    mask = rb[:, :, 0] > 1e-4
    assert mask.sum() > 200
    err = np.abs(got[mask] / expect[mask] - 1.0)
    assert np.median(err) < 0.02
    assert np.percentile(err, 95) < 0.08
    assert err.max() < 0.25


def _radius(**kw):
    pts = _pixel_world_points(**kw)
    return np.sqrt(pts[:, :, 0] ** 2 + pts[:, :, 1] ** 2)


def test_spot_cone_and_interior_match():
    h, outer = 40.0, 25.0
    point = {"type": "point", "position": [0, 0, h],
             "intensity": [500, 500, 500]}
    spot = {"type": "spot", "position": [0, 0, h], "direction": [0, 0, -1],
            "intensity": [500, 500, 500], "inner_deg": outer,
            "outer_deg": outer}
    r0 = _drender([dict(point, intensity=[0, 0, 0])])
    dp = _drender([point]) - r0
    ds = _drender([spot]) - r0
    r = _radius()
    edge = h * np.tan(np.radians(outer))
    # a pixel's samples spread up to ~2.3 world units from its centre
    outside, inside = r > edge + 3.0, r < edge - 3.0
    assert outside.sum() > 50 and inside.sum() > 50
    np.testing.assert_allclose(ds[outside], 0.0, atol=1e-7)
    np.testing.assert_allclose(ds[inside], dp[inside], rtol=1e-5, atol=1e-6)


def test_spot_soft_falloff_monotone():
    h = 70.0
    spot = {"type": "spot", "position": [0, 0, h], "direction": [0, 0, -1],
            "intensity": [2000, 2000, 2000], "inner_deg": 10.0,
            "outer_deg": 35.0}
    point = {"type": "point", "position": [0, 0, h],
             "intensity": [2000, 2000, 2000]}
    r0 = _drender([dict(spot, intensity=[0, 0, 0])])
    ds = (_drender([spot]) - r0)[:, :, 0]
    dp = (_drender([point]) - r0)[:, :, 0]
    r = _radius()
    ok = dp > 1e-5
    fall = np.where(ok, ds / np.maximum(dp, 1e-12), 0.0)
    inner = ok & (r < h * np.tan(np.radians(10.0)) - 2.5)
    mid = ok & (r > h * np.tan(np.radians(15.0)) + 2.5) \
        & (r < h * np.tan(np.radians(30.0)) - 2.5)
    outer = ok & (r > h * np.tan(np.radians(35.0)) + 3.0)
    assert inner.sum() > 10 and mid.sum() > 50 and outer.sum() > 20
    np.testing.assert_allclose(fall[inner], 1.0, rtol=0.02)
    assert 0.01 < fall[mid].mean() < 0.95
    np.testing.assert_allclose(fall[outer], 0.0, atol=1e-6)


def test_directional_flat_irradiance():
    point = {"type": "point", "position": [0, 0, 30],
             "intensity": [500, 500, 500]}
    sun = {"type": "directional", "direction": [0, 0, -1],
           "intensity": [2, 2, 2]}
    dark = dict(point, intensity=[0, 0, 0])
    dp = (_drender([point]) - _drender([dark]))[:, :, 0]
    dd = (_drender([dark, sun])
          - _drender([dark, dict(sun, intensity=[0, 0, 0])]))[:, :, 0]
    expect_dir = (ALBEDO / np.pi) * 2.0
    assert abs(dd.mean() / expect_dir - 1.0) < 0.15
    assert dd.std() / dd.mean() < 0.6
    expect_pt = _point_val(_pixel_world_points(), [0, 0, 30],
                           point["intensity"])
    assert abs((dp / expect_pt).mean() - 1.0) < 0.15


def test_point_occlusion_umbra():
    """A blocker (r=5 at z=32) under a point light at z=45 shadows the
    floor out to r = 5 * 45 / 13 = 17.3.  From 100 units up, at 64x64
    (pixels of 2.3 units), the camera sees the blocker out to r = 7.4 on
    the floor; between the two the floor lies in the umbra."""
    blocker = Spheres(
        center=np.array([[0.0, 0.0, -1e4], [0.0, 0.0, 32.0]], np.float32),
        radius=np.array([1e4, 5.0], np.float32),
        color=np.array([[ALBEDO] * 3, [0.2, 0.2, 0.2]], np.float32),
        emission=np.zeros((2, 3), np.float32),
        refl=np.array([DIFF, DIFF], np.int32))
    light = {"type": "point", "position": [0, 0, 45],
             "intensity": [800, 800, 800]}
    kw = dict(cam_z=100.0, size=64)
    r0 = _drender([dict(light, intensity=[0, 0, 0])], spheres=blocker, **kw)
    d = (_drender([light], spheres=blocker, **kw) - r0)[:, :, 0]
    r = _radius(**kw)
    umbra = (r > 7.4 + 2.4) & (r < 15.0)
    lit = (r > 19.7) & (r < 45.0)
    assert umbra.sum() > 20 and lit.sum() > 100
    np.testing.assert_allclose(d[umbra], 0.0, atol=1e-7)
    assert (d[lit] > 1e-5).mean() > 0.5


def test_mis_delta_weight_is_one():
    light = {"type": "point", "position": [0, 0, 30],
             "intensity": [400, 400, 400]}
    dark = [dict(light, intensity=[0, 0, 0])]
    d_off = _drender([light]) - _drender(dark)
    d_on = _drender([light], mis=True) - _drender(dark, mis=True)
    np.testing.assert_allclose(d_on, d_off, rtol=1e-5, atol=1e-6)


def test_smoke_with_area_lights_and_delta():
    img = _drender([{"type": "point", "position": [0, -80, 60],
                     "intensity": [300, 300, 300]}],
                   spheres=Spheres.default_seven())
    assert np.isfinite(img).all() and img.max() > 0


def test_from_specs_validation():
    for bad in ([{"type": "laser"}], [{"type": "point"}],
                [{"type": "spot", "position": [0, 0, 1]}],
                [{"type": "directional", "direction": [0, 0, 0]}],
                [{"type": "spot", "position": [0, 0, 1],
                  "direction": [0, 0, -1], "inner_deg": 50,
                  "outer_deg": 20}]):
        with pytest.raises(ValueError):
            DeltaLights.from_specs(bad)
    dl = DeltaLights.from_specs([
        {"type": "point", "position": [1, 2, 3], "intensity": [5, 5, 5]},
        {"type": "spot", "position": [0, 0, 9], "direction": [0, 0, -2],
         "outer_deg": 30},
        {"type": "directional", "direction": [1, 0, 0]}])
    assert dl.count == 3 and dl.kind.tolist() == [DL_POINT, DL_SPOT, 2]
    np.testing.assert_allclose(np.linalg.norm(dl.direction, axis=1), 1.0,
                               rtol=1e-6)
    rows = dl.pack()
    assert rows.shape == (3, 12)
    np.testing.assert_allclose(rows[1, 11], np.cos(np.radians(30)),
                               rtol=1e-6)


def test_json_description_lights(tmp_path):
    import json

    from tyrant_tpu_torch.scene.description import load_description
    p = tmp_path / "scene.json"
    p.write_text(json.dumps({
        "spheres": [{"center": [0, 0, -1e4], "radius": 1e4,
                     "color": [0.75, 0.75, 0.75]}],
        "lights": [{"type": "point", "position": [0, 0, 30],
                    "intensity": [100, 100, 100]},
                   {"type": "directional", "direction": [0, 0, -1],
                    "intensity": [1, 1, 1]}]}))
    bundle = load_description(str(p))
    assert bundle.scene.delta_lights.count == 2
    sd = bundle.scene.to_device("cpu")
    assert sd.n_delta_lights == 2 and sd.delta_lights.shape == (2, 12)
