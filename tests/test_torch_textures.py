"""Textured surfaces on the CPU, against the JAX package on the same numpy
inputs.

- ``_sample_texture`` against the JAX ``_sample_texture`` and the numpy
  oracles of ``scene/texture.py`` under every filter, every wrap mode and
  ``channels=4``, within 1e-6 absolute (the oracles at test_texture's
  2e-5); under "trilinear" the rays whose lod lies within 2 ulp of an
  integer may take the other level pair (``log2`` may differ by an ulp):
  they are counted, at most 2 in 4,096, and left out.
- The upload: the textured scene of ``scene/files.py`` (albedo, normal,
  roughness/metal, cutout-leaf and blend maps with clamp and mirrored
  wraps) through test_torch_loaders.check_tables (``tex_data``,
  ``tex_meta``, ``tri_attr``, the refl-lane flags and the gates bit for
  bit) and through interop; the texture-modulated emitter's table row.
- ``_shade`` against the JAX ``_shade`` on one queue of each texture
  feature (albedo, normal, rough, metal, cutout, blend, and all of them
  under each filter): the pass-through and metal picks (through the refl
  codes of the next rays), ``shadow.valid``, Russian roulette, the next
  rays' integer fields and last_specular exact; colours, directions and
  throughputs within 1e-5 absolute (the float chains differ in the last
  ulp); the rays whose trilinear lod tie flips counted as above.
- ``render_aovs`` against the JAX pass (the normals within 1e-4: the
  walks' hit points an ulp apart, amplified by the normal map's slopes),
  and the textured scene through
  both Renderers for 5 steps (the same slots through step 4, path counts
  on >= 99% of the pixels, image means within 0.01).
- The estimator checks of test_texture, test_normal_map, test_rough_map,
  test_alpha_cutout, test_alpha_blend and test_metal_map that hold on
  the port alone (a constant texture shades as the colour, an identity
  normal map changes nothing, a constant rough map equals the scalar, a
  fully transparent quad equals no quad, metalness 1 equals GGX, a blend
  alpha of 1 is opaque)."""

import dataclasses
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tyrant_tpu import render as jr
from tyrant_tpu import sky as jsky
from tyrant_tpu.camera import Camera as JCamera
from tyrant_tpu.config import small_config as jsmall_config
from tyrant_tpu.ops.tonemap import resolve as jresolve
from tyrant_tpu.scene.scene import Scene as JScene
from tyrant_tpu.scene.texture import TextureAtlas as JTextureAtlas
from tyrant_tpu_torch import interop
from tyrant_tpu_torch import render as tr
from tyrant_tpu_torch import sky as tsky
from tyrant_tpu_torch.camera import Camera
from tyrant_tpu_torch.config import small_config
from tyrant_tpu_torch.ops.tonemap import resolve
from tyrant_tpu_torch.scene import files
from tyrant_tpu_torch.scene.procgen import terrain
from tyrant_tpu_torch.scene.scene import GGX, LIGHT, Scene
from tyrant_tpu_torch.scene.texture import (TextureAtlas, sample_bilinear_np,
                                            sample_nearest_np,
                                            sample_trilinear_np)

from .test_torch_loaders import check_tables

SUN = (0.05, 0.3)
ATOL = 1e-6
SHADE_ATOL = 1e-5
SMALL_PX = dict(albedo_px=32, normal_px=32, rough_px=16, leaf_px=16)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One PyTorch thread: beside the other test workers the default of a
    thread a core oversubscribes the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --------------------------------------------------------------------------
# the sampler
# --------------------------------------------------------------------------

def _ramp(h, w, seed, c=4):
    return np.random.default_rng(seed).random((h, w, c)).astype(np.float32)


def _fake_scenes(images, wraps=None):
    """(JAX scene, port scene, atlas) holding only the texel atlas with
    mips and its static meta, as the samplers read them."""
    at = TextureAtlas.pack(images, mips=True)
    wraps = wraps or [(0, 0)] * len(images)
    meta = tuple((int(o), int(h), int(w), int(ws), int(wt),
                  tuple((int(a), int(b), int(c)) for (a, b, c) in chain))
                 for (o, h, w), (ws, wt), chain in zip(at.meta, wraps,
                                                       at.mip_meta))
    return (types.SimpleNamespace(tex_meta=meta,
                                  tex_data=jnp.asarray(at.data)),
            types.SimpleNamespace(tex_meta=meta,
                                  tex_data=torch.from_numpy(at.data)), at)


def _lod_ties(at, texid, fpu, fpv):
    """Rays whose trilinear lod, unclamped (a footprint above one texel),
    lies within 2 ulp of a nonzero integer: there ``log2`` an ulp apart
    may pick the other pair of levels (with a blend weight of an ulp)."""
    w = np.asarray([at.meta[k][2] for k in np.maximum(texid, 0)], np.float32)
    h = np.asarray([at.meta[k][1] for k in np.maximum(texid, 0)], np.float32)
    raw = np.maximum(fpu * w, fpv * h)
    lod = np.log2(np.maximum(raw, 1.0))
    near = np.abs(lod - np.round(lod)) <= 2 * np.spacing(
        np.maximum(np.abs(lod), 1.0))
    return (raw > 1.0) & (np.round(lod) > 0) & near


@pytest.mark.parametrize("mode", ["nearest", "bilinear", "trilinear"])
@pytest.mark.parametrize("wraps", ["repeat", "mixed"])
@pytest.mark.parametrize("channels", [3, 4])
def test_sampler_matches_jax(mode, wraps, channels):
    ims = [_ramp(13, 9, 1), _ramp(6, 17, 2, 3), _ramp(16, 16, 3)]
    wr = None if wraps == "repeat" else [(1, 2), (2, 0), (0, 1)]
    js, ts, at = _fake_scenes(ims, wr)
    r = np.random.default_rng(5)
    n = 4096
    texid = r.integers(-1, 3, n).astype(np.int32)
    u = r.uniform(-2.0, 2.5, n).astype(np.float32)
    v = r.uniform(-2.0, 2.5, n).astype(np.float32)
    fpu = (2.0 ** r.uniform(-7, 4, n) / 16).astype(np.float32)
    fpv = (2.0 ** r.uniform(-7, 4, n) / 16).astype(np.float32)
    want = np.asarray(jr._sample_texture(
        js, jnp.asarray(texid), jnp.asarray(u), jnp.asarray(v), mode,
        channels=channels, uv_fp=(jnp.asarray(fpu), jnp.asarray(fpv))))
    got = tr._sample_texture(
        ts, torch.from_numpy(texid), torch.from_numpy(u),
        torch.from_numpy(v), mode, channels=channels,
        uv_fp=(torch.from_numpy(fpu), torch.from_numpy(fpv))).numpy()
    assert got.shape == want.shape == (n, channels)
    keep = np.ones(n, bool)
    if mode == "trilinear":
        tie = _lod_ties(at, texid, fpu, fpv)
        assert tie.sum() <= 2, tie.sum()
        keep = ~tie
    np.testing.assert_allclose(got[keep], want[keep], rtol=0, atol=ATOL)
    # untextured ids tap row 0, the white fallback (the bilinear weights
    # sum to 1 within an ulp)
    np.testing.assert_allclose(got[texid < 0], 1.0, rtol=0, atol=ATOL)
    if wraps == "repeat" and channels == 3:
        # and the numpy oracles (test_texture, test_texture_mips)
        ok = texid >= 0
        if mode == "trilinear":
            w = np.asarray([at.meta[k][2] for k in np.maximum(texid, 0)])
            h = np.asarray([at.meta[k][1] for k in np.maximum(texid, 0)])
            lod = np.log2(np.maximum(np.maximum(fpu * w, fpv * h), 1.0))
            oracle = sample_trilinear_np(at, texid, u, v, lod)
            ok &= keep
        else:
            oracle = {"nearest": sample_nearest_np,
                      "bilinear": sample_bilinear_np}[mode](at, texid, u, v)
        np.testing.assert_allclose(got[ok], oracle[ok], rtol=2e-5, atol=2e-5)


def test_trilinear_zero_footprint_is_bilinear():
    """test_texture_mips: a zero footprint samples level 0 bilinearly."""
    js, ts, at = _fake_scenes([_ramp(16, 16, 7, 3)])
    r = np.random.default_rng(9)
    n = 128
    texid = torch.zeros(n, dtype=torch.int32)
    u = torch.from_numpy(r.uniform(0, 1, n).astype(np.float32))
    v = torch.from_numpy(r.uniform(0, 1, n).astype(np.float32))
    z = torch.zeros(n)
    tri = tr._sample_texture(ts, texid, u, v, "trilinear", uv_fp=(z, z))
    bil = tr._sample_texture(ts, texid, u, v, "bilinear")
    np.testing.assert_array_equal(tri.numpy(), bil.numpy())


def test_wrap_modes():
    """test_tex_wrap: a 2x1 texture (left black, right white) tapped
    nearest under repeat, clamp and mirrored repeat."""
    tex = np.zeros((1, 2, 3), np.float32)
    tex[0, 1] = 1.0
    us = np.float32([-0.3, 0.2, 0.8, 1.3, 2.2])
    want = {(0, 0): [1, 0, 1, 0, 0], (1, 0): [0, 0, 1, 1, 1],
            (2, 0): [0, 0, 1, 1, 0]}
    for wrap, vals in want.items():
        _, ts, _ = _fake_scenes([tex], [wrap])
        got = tr._sample_texture(
            ts, torch.zeros(5, dtype=torch.int32), torch.from_numpy(us),
            torch.full((5,), 0.5), "nearest")[:, 0]
        np.testing.assert_array_equal(got.numpy(), vals)


def test_atlas_with_mips_matches_jax():
    ims = [_ramp(13, 9, 1), _ramp(6, 17, 2, 3)]
    a = TextureAtlas.pack(ims, mips=True)
    b = JTextureAtlas.pack(ims, mips=True)
    np.testing.assert_array_equal(a.data.view(np.uint32),
                                  b.data.view(np.uint32))
    np.testing.assert_array_equal(a.meta, b.meta)
    assert a.mip_meta == b.mip_meta


# --------------------------------------------------------------------------
# scenes
# --------------------------------------------------------------------------

def textured_kw(n_quads=16, n_leaves=1024, n_blend=512, seed=11, **over):
    """files.textured_scene at a small size (both packages' from_triangles
    take its keyword arguments), with ``over`` replacing records, under
    the default seven spheres but the ground sphere, which would hide most
    of this small terrain."""
    kw = files.textured_scene(*terrain(n_quads=n_quads, extent=80.0, towers=2),
                              n_leaves=n_leaves, n_blend=n_blend, seed=seed,
                              ground_z=-1e9, **SMALL_PX)
    kw.update(over)
    return kw


def _spheres(cls):
    s = cls.default_seven()
    keep = np.arange(s.count) != 4  # the ground sphere
    return cls(center=s.center[keep], radius=s.radius[keep],
               color=s.color[keep], emission=s.emission[keep],
               refl=s.refl[keep])


def _only(kw, *keep):
    """The textured scene with the maps not in ``keep`` taken off
    ("albedo", "normal", "rough", "metal", "alpha", "blend")."""
    kw = dict(kw)
    t = kw["tri_tex"].shape[0]
    none = np.full(t, -1, np.int32)
    if "normal" not in keep:
        kw["tri_ntex"] = none
    if "rough" not in keep and "metal" not in keep:
        kw["tri_rtex"] = none
    if "metal" not in keep:
        kw["tri_metal"] = np.zeros(t, bool)
    if "blend" not in keep:
        kw["tri_blend"] = np.zeros(t, bool)
    if "albedo" not in keep and "alpha" not in keep and "blend" not in keep:
        kw["tri_tex"] = none
    elif "alpha" not in keep and "blend" not in keep:
        # the albedo alone: the leaf and pane maps opaque
        kw["textures"] = [im if im.shape[2] < 4 else
                          np.concatenate([im[..., :3], np.ones_like(
                              im[..., 3:])], -1) for im in kw["textures"]]
    return kw


def both(kw):
    from tyrant_tpu.scene.scene import Spheres as JSpheres

    from tyrant_tpu_torch.scene.scene import Spheres
    return (JScene.from_triangles(builder="numpy", spheres=_spheres(JSpheres),
                                  **kw),
            Scene.from_triangles(builder="numpy", spheres=_spheres(Spheres),
                                 **kw))


def pose(cls=Camera):
    """Over the terrain, looking down across the leaves and panes."""
    cam = cls()
    cam.position = np.array([0.0, -100.0, 60.0], np.float32)
    cam.vertical_angle = -0.5
    return cam


# --------------------------------------------------------------------------
# the upload
# --------------------------------------------------------------------------

def test_textured_scene_tables_bitwise():
    js, ts = both(textured_kw())
    jd, td = js.to_device(), ts.to_device("cpu")
    check_tables(jd, td)
    assert (td.has_albedo_tex and td.has_normal_maps and td.has_rough_maps
            and td.has_alpha_tex and td.has_blend and td.has_metal_maps)
    assert [m[3:5] for m in td.tex_meta] == \
        [tuple(w) for w in files.TEXTURE_WRAPS]
    refl = td.tri_shade[:, 3].numpy()
    assert (refl >= 32).any() and ((refl >= 16) & (refl < 32)).any()
    # the JAX SceneData carried over as numpy (interop) is the same scene
    from tyrant_tpu.ops.pallas.traverse_kernel import PacketTables as JPT
    leaves = {k: np.asarray(getattr(jd.bvh, k))
              for k in interop.SCENE_LEAVES[:4]}
    leaves.update({k: np.asarray(getattr(jd, k))
                   for k in interop.SCENE_LEAVES[4:]})
    carried, _ = interop.scene_from_numpy(
        leaves, np.asarray(JPT(jd.bvh).rows), "cpu",
        flags={k: getattr(jd, k) for k in interop.SCENE_FLAGS},
        aux={k: getattr(jd, k) for k in interop.SCENE_AUX})
    check_tables(jd, carried)


def test_flags_only_under_their_gates():
    """A blend flag without cutout alpha and a metal flag without a rough
    map or on a non-GGX triangle are dropped, as in the JAX packer."""
    kw = _only(textured_kw(), "albedo")
    kw["tri_blend"] = np.ones(kw["tri_tex"].shape[0], bool)
    kw["tri_metal"] = np.ones(kw["tri_tex"].shape[0], bool)
    js, ts = both(kw)
    td = ts.to_device("cpu")
    check_tables(js.to_device(), td)
    assert not (td.has_blend or td.has_metal_maps or td.has_alpha_tex)
    assert (td.tri_shade[:, 3] < 16).all()
    kw = _only(textured_kw(), "albedo", "rough")
    kw["tri_metal"] = np.ones(kw["tri_tex"].shape[0], bool)
    js, ts = both(kw)
    td = ts.to_device("cpu")
    check_tables(js.to_device(), td)
    refl = td.tri_shade[:, 3].numpy()
    assert td.has_metal_maps and set(np.unique(refl)) == {0.0, GGX + 32.0}


def test_texture_modulated_emitter_table():
    """An emissive triangle under an albedo texture: NEE and the power
    table take the texture's mean (J:scene/scene.py:789-803)."""
    kw = textured_kw()
    refl = kw["tri_refl"].copy()
    lit = np.arange(0, 64, 8)
    refl[lit] = LIGHT
    color = kw["tri_color"].copy()
    color[lit] = (3.0, 2.5, 2.0)
    kw.update(tri_refl=refl, tri_color=color)
    js, ts = both(kw)
    jd, td = js.to_device(), ts.to_device("cpu")
    check_tables(jd, td)
    mean = kw["textures"][0][..., :3].reshape(-1, 3).mean(0)
    np.testing.assert_allclose(td.tri_lights[:, 9:12].numpy(),
                               np.tile(np.float32([3.0, 2.5, 2.0]) * mean,
                                       (lit.size, 1)), rtol=1e-6)


# --------------------------------------------------------------------------
# _shade against the JAX _shade
# --------------------------------------------------------------------------

SHADE_CASES = {
    "albedo": (("albedo",), "bilinear"),
    "normal": (("albedo", "normal"), "bilinear"),
    "rough": (("rough",), "bilinear"),
    "metal": (("rough", "metal"), "bilinear"),
    "cutout": (("albedo", "alpha"), "bilinear"),
    "blend": (("albedo", "alpha", "blend"), "bilinear"),
    "all_nearest": (("albedo", "normal", "rough", "metal", "alpha", "blend"),
                    "nearest"),
    "all_trilinear": (("albedo", "normal", "rough", "metal", "alpha",
                       "blend"), "trilinear"),
}


def queue_and_shade(js, ts, cfg, steps=3, cam=pose):
    """A step queue of the port's Renderer after ``steps`` steps, extended
    and shaded by both packages on the same hits."""
    tren = tr.Renderer(ts, cfg, device="cpu", sun_position=SUN)
    tren.step(cam(), steps)
    td = tren.scene
    rays = tr.merge_queue(cfg, tren.state, tren._last_cam)
    jd = js.to_device()
    jrays = {k: jnp.asarray(v.numpy()) for k, v in rays.items()}
    jt, jid, jtri, _ = jr._intersect_scene(jrays["origin"],
                                           jrays["direction"], jd)
    frame = int(tren.state.frame)
    jc, _, jsurv, jnext, jshadow = jr._shade(
        cfg, jd, jsky.SkyParams(cfg.sky),
        jsky.sun_direction_from_position(jnp.asarray(SUN)), jrays,
        jt, jid, jtri, jnp.uint32(frame))
    out = tr._shade(cfg, td, tsky.SkyParams(cfg.sky), tren.sun_dir, rays,
                    torch.from_numpy(np.array(jt)),
                    torch.from_numpy(np.array(jid)),
                    torch.from_numpy(np.array(jtri)), torch.tensor(frame))
    return dict(port=out, jax=(jc, jsurv, jnext, jshadow), td=td, jd=jd,
                rays=rays, t=np.asarray(jt), ident=np.asarray(jid),
                is_tri=np.asarray(jtri))


def trilinear_ties(q, cfg):
    """The queue's rays whose trilinear lod lies within 2 ulp of an
    integer for any of their triangle's maps, from the JAX footprint."""
    td, rays = q["td"], q["rays"]
    hit = (q["t"] < 1e20) & q["is_tri"]
    tid = np.clip(q["ident"], 0, td.tri_attr.shape[0] - 1)
    arow = td.tri_attr.numpy()[tid]
    t_safe = np.where(q["t"] < 1e20, q["t"], 0.0).astype(np.float32)
    gu = arow[:, 3:6] * arow[:, 11:12] + arow[:, 6:9] * arow[:, 13:14]
    gv = arow[:, 3:6] * arow[:, 12:13] + arow[:, 6:9] * arow[:, 14:15]
    fp = t_safe * np.float32(1.5 / cfg.height)
    fpu = fp * np.sqrt(np.maximum((gu * gu).sum(1), 1e-20))
    fpv = fp * np.sqrt(np.maximum((gv * gv).sum(1), 1e-20))
    tie = np.zeros(hit.shape, bool)
    at = types.SimpleNamespace(meta=[m[:3] for m in td.tex_meta])
    for lane in (15, 26, 31):
        ids = arow[:, lane].astype(np.int32)
        tie |= hit & (ids >= 0) & _lod_ties(at, ids, fpu, fpv)
    return tie


def check_shade(q, cfg, ties=None):
    tc, tsurv, tnext, tshadow = q["port"]
    jc, jsurv, jnext, jshadow = q["jax"]
    ok = np.ones(cfg.num_rays, bool) if ties is None else ~ties
    np.testing.assert_array_equal(tsurv.numpy()[ok], np.asarray(jsurv)[ok])
    valid = tshadow["valid"].numpy()
    np.testing.assert_array_equal(valid[ok],
                                  np.asarray(jshadow["valid"])[ok])
    assert valid.sum() > 100
    np.testing.assert_allclose(tc.numpy()[ok], np.asarray(jc)[ok], rtol=0,
                               atol=SHADE_ATOL)
    for k in ("origin", "direction", "direct"):
        np.testing.assert_allclose(tnext[k].numpy()[ok],
                                   np.asarray(jnext[k])[ok], rtol=1e-5,
                                   atol=SHADE_ATOL, err_msg=k)
    for k in ("pixel", "bounces", "last_specular"):
        np.testing.assert_array_equal(tnext[k].numpy()[ok],
                                      np.asarray(jnext[k])[ok], err_msg=k)
    for k in ("direction", "color"):
        np.testing.assert_allclose(tshadow[k].numpy()[ok & valid],
                                   np.asarray(jshadow[k])[ok & valid],
                                   rtol=1e-5, atol=SHADE_ATOL, err_msg=k)


@pytest.mark.parametrize("case", list(SHADE_CASES))
def test_shade_matches_jax(case):
    keep, filt = SHADE_CASES[case]
    cfg = small_config(width=32, height=32, num_rays=4096,
                       texture_filter=filt)
    kw = _only(textured_kw(), *keep)
    js, ts = both(kw)
    q = queue_and_shade(js, ts, cfg)
    td = q["td"]
    assert td.has_textures == any(k in keep for k in ("albedo", "alpha",
                                                       "blend"))
    assert td.has_normal_maps == ("normal" in keep)
    assert td.has_metal_maps == ("metal" in keep)
    assert td.has_alpha_tex == ("alpha" in keep)
    assert td.has_blend == ("blend" in keep)
    ties = trilinear_ties(q, cfg) if filt == "trilinear" else None
    if ties is not None:
        assert ties.sum() <= 2, ties.sum()
    check_shade(q, cfg, ties)
    # the queue reaches the feature: hits on its triangles (the refl lane's
    # flags), and pass-throughs that go on along their own direction
    hit = (q["t"] < 1e20) & q["is_tri"]
    lane = td.tri_shade[:, 3].numpy()[np.clip(q["ident"], 0, None)]
    if "metal" in keep:
        assert (hit & (lane >= 32)).sum() > 20
    if "blend" in keep:
        assert (hit & (lane >= 16) & (lane < 32)).sum() > 5
    if "alpha" in keep:
        tnext, rays = q["port"][2], q["rays"]
        same_dir = (tnext["direction"] == rays["direction"]).all(1)
        assert int(same_dir.sum()) > 20


# --------------------------------------------------------------------------
# the AOV pass and the Renderer
# --------------------------------------------------------------------------

@pytest.mark.parametrize("filt", ["nearest", "trilinear"])
def test_render_aovs_matches_jax(filt):
    cfg = small_config(width=32, height=32, num_rays=4096,
                       texture_filter=filt)
    js, ts = both(textured_kw())
    cam = pose()
    td = ts.to_device("cpu")
    tables = tr.PacketTables(td.bvh)
    got = tr.render_aovs(td, cam.to_device(cfg, "cpu"), cfg, tables)
    jcam = pose(JCamera)
    want = jr.render_aovs(js.to_device(), jcam.to_device(cfg), cfg)
    # the walks' hit points differ in the last ulp, which the normal
    # map's texel-scale slopes amplify to 1e-4 on a few pixels
    for k, tol in (("albedo", 1e-5), ("normal", 1e-4), ("depth", 1e-5)):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=tol, atol=tol, err_msg=k)
    alb = got["albedo"].numpy()
    assert np.unique(alb.reshape(-1, 3), axis=0).shape[0] > 50


def carried(st):
    """A state's carried (pixel, bounces) pairs, slot by slot."""
    n = int(st.n_carried)
    return np.stack([np.asarray(st.pixel)[:n], np.asarray(st.bounces)[:n]],
                    1)


@pytest.mark.parametrize("filt", ["bilinear", "trilinear"])
def test_textured_scene_renders_like_jax(filt):
    """The textured scene through both Renderers: every carried ray in
    the same slot through step 4, then after step 5 the per-pixel path
    counts on >= 99% of the pixels (99.9% measured under "bilinear", 100%
    under "trilinear") and the images within 0.01 mean.  Later steps
    drift apart: the states' float noise, which the normal map's
    texel-scale slopes turn into other bounce directions, changes a
    survivor in step 5, and the sort moves the rays after it to other
    slots, whose draws differ (98.8% of the pixel counts agree after step
    6 under "bilinear")."""
    w = h = 32
    kw = textured_kw()
    cfg = small_config(width=w, height=h, num_rays=4096, texture_filter=filt)
    jcfg = jsmall_config(width=w, height=h, num_rays=4096,
                         texture_filter=filt)
    jsc, tsc = both(kw)
    jren = jr.Renderer(jsc, jcfg, sun_position=SUN, donate=False)
    tren = tr.Renderer(tsc, cfg, device="cpu", sun_position=SUN)
    jren.step(pose(JCamera), 4)
    tren.step(pose(), 4)
    np.testing.assert_array_equal(carried(tren.state), carried(jren.state))
    jren.step(pose(JCamera), 1)
    tren.step(pose(), 1)
    ja, ta = np.asarray(jren.state.accum), tren.state.accum.numpy()
    assert np.isfinite(ta).all() and ja[:, 3].sum() > 0
    assert (ta[:, 3] == ja[:, 3]).mean() >= 0.99
    diff = np.abs(resolve(tren.state.accum, w, h).numpy()
                  - np.asarray(jresolve(jnp.asarray(ja), w, h)))
    assert diff.mean() < 0.01, diff.mean()
    img = tren.image(denoise=True)
    assert img.shape == (h, w, 3) and torch.isfinite(img).all()


# --------------------------------------------------------------------------
# the estimator checks that hold on the port alone
# --------------------------------------------------------------------------

def _quad(tex=None, color=(1.0, 1.0, 1.0), **kw):
    """A 400-unit floor quad at z = 0 under one texture (uv 0..1 over
    it), without spheres but a far dark one."""
    from tyrant_tpu_torch.scene.scene import Spheres
    half = 200.0
    v0 = np.float32([[-half, -half, 0], [half, half, 0]])
    v1 = np.float32([[half, -half, 0], [-half, half, 0]])
    v2 = np.float32([[-half, half, 0], [half, -half, 0]])
    uv = np.stack([(v[:, :2] + half) / (2 * half) for v in (v0, v1, v2)], 1)
    sph = Spheres(center=np.float32([[0, 0, -5e4]]),
                  radius=np.float32([1.0]), color=np.float32([[0, 0, 0]]),
                  emission=np.float32([[0, 0, 0]]),
                  refl=np.int32([0]))
    if tex is not None:
        kw.setdefault("textures", [tex])
        kw.setdefault("tri_tex", np.zeros(2, np.int32))
        kw["tri_uv"] = uv.astype(np.float32)
    return Scene.from_triangles(v0, v1, v2, builder="numpy", spheres=sph,
                                tri_color=np.tile(np.float32(color), (2, 1)),
                                **kw)


def _down_cfg(**kw):
    return small_config(width=16, height=16, num_rays=1024, **kw)


def _down():
    cam = Camera()
    cam.position = np.array([0.0, 0.0, 60.0], np.float32)
    cam.vertical_angle = -1.5
    return cam


def _render(scene, steps=6, **kw):
    r = tr.Renderer(scene, _down_cfg(**kw), device="cpu", sun_position=SUN)
    r.step(_down(), steps)
    return r.state.accum.clone()


def test_constant_texture_equals_tri_color():
    """test_texture: a constant texture shades exactly as that colour."""
    col = np.float32([0.25, 0.5, 1.0])
    a = _render(_quad(np.tile(col, (4, 4, 1))), texture_filter="nearest")
    b = _render(_quad(np.ones((4, 4, 3), np.float32), color=col),
                texture_filter="nearest")
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_identity_normal_map_is_noop():
    """test_normal_map: a flat (0.5, 0.5, 1) map changes nothing."""
    flat = np.tile(np.float32([0.5, 0.5, 1.0]), (4, 4, 1))
    a = _render(_quad(flat, tri_tex=np.full(2, -1, np.int32),
                      tri_ntex=np.zeros(2, np.int32)))
    b = _render(_quad(None))
    torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def test_constant_rough_map_matches_scalar():
    """test_rough_map: a constant roughness map equals the scalar."""
    rm = np.full((4, 4, 3), 0.35, np.float32)
    refl = np.full(2, GGX, np.int32)
    a = _render(_quad(rm, tri_tex=np.full(2, -1, np.int32),
                      tri_rtex=np.zeros(2, np.int32), tri_refl=refl,
                      tri_rough=np.full(2, 0.6, np.float32)))
    b = _render(_quad(None, tri_refl=refl,
                      tri_rough=np.full(2, np.float32(0.35))))
    torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def test_fully_transparent_quad_is_no_quad():
    """test_alpha_cutout: a quad of alpha 0 over a floor passes every ray
    through to the floor."""
    floor = _quad(None)
    v0, e1, e2 = floor.tri_vert, floor.tri_e1, floor.tri_e2
    lift = np.float32([0, 0, 20])
    over = Scene.from_triangles(
        np.concatenate([v0, v0 + lift]),
        np.concatenate([v0 + e1, v0 + e1 + lift]),
        np.concatenate([v0 + e2, v0 + e2 + lift]),
        builder="numpy", spheres=floor.spheres,
        tri_uv=np.zeros((4, 3, 2), np.float32),
        tri_tex=np.int32([-1, -1, 0, 0]),
        textures=[np.zeros((4, 4, 4), np.float32)])
    assert over.to_device("cpu").has_alpha_tex
    a = _render(over, steps=4)
    b = _render(floor, steps=4)
    # the pass-through costs each path one step: compare the radiance a
    # path
    assert float(a[:, 3].sum()) > 0
    ma = (a[:, :3].sum(0) / a[:, 3].sum()).numpy()
    mb = (b[:, :3].sum(0) / b[:, 3].sum()).numpy()
    np.testing.assert_allclose(ma, mb, rtol=0.1)


def test_metalness_one_is_exactly_ggx():
    """test_metal_map: metalness 1 shades exactly as the GGX conductor."""
    mr = np.zeros((4, 4, 3), np.float32)
    mr[..., 0] = 0.3
    mr[..., 1] = 1.0
    refl = np.full(2, GGX, np.int32)
    common = dict(tri_tex=np.full(2, -1, np.int32),
                  tri_rtex=np.zeros(2, np.int32), tri_refl=refl)
    a = _render(_quad(mr, tri_metal=np.ones(2, bool), **common))
    b = _render(_quad(mr, **common))
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_blend_alpha_one_is_opaque():
    """test_alpha_blend: blend triangles of alpha 1 never pass through
    (the scene keeps its cutout gate from a second, holed texture)."""
    opaque = np.ones((4, 4, 4), np.float32)
    holed = np.ones((4, 4, 4), np.float32)
    holed[0, 0, 3] = 0.0
    kw = dict(textures=[opaque, holed], tri_blend=np.ones(2, bool))
    sc = _quad(opaque, **kw)
    sd = sc.to_device("cpu")
    assert sd.has_blend and sd.has_alpha_tex
    a = _render(sc)
    b = _render(_quad(opaque, textures=[opaque, holed]))
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_textured_renderer_config_fields():
    """texture_filter is a ported field under every value."""
    for filt in ("nearest", "bilinear", "trilinear"):
        cfg = dataclasses.replace(_down_cfg(), texture_filter=filt)
        assert cfg.texture_filter == filt
