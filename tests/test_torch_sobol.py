"""The Sobol sampler (``RenderConfig.sampler="sobol"``) on the CPU,
against the JAX package on the same numpy inputs.

- Every function of ``ops/sobol.py`` bit-equal to ``tyrant_tpu.ops.sobol``
  on the u32 edge values (0, 1, 2^31 - 1, 2^31, 2^32 - 2, 2^32 - 1) and
  random u32s; the split multiply exact against Python's integers.
- test_sobol's checks on the port: the elementary intervals of every
  2^k prefix, the 1-D prefix stratification, key decorrelation, the
  state's Sobol fields and the sample-index bookkeeping.
- Raygen under Sobol (with and without ``seed``): pixels and sample
  indices exact, origins and directions within 1e-6.
- ``_shade`` under Sobol against the JAX ``_shade`` on one queue of the
  lights, fog and materials scenes (GGX, rough glass, IOR, dispersion):
  the light picks (power-CDF ties within 2 ulp counted, at most 2),
  Russian roulette, ``shadow.valid`` and the next rays' integer fields
  and last_specular exact; the rest within 1e-4.
- Both Renderers under Sobol: the same carried rays in the same slots
  through step 4, the path counts and images after 6 steps.
- test_envlight's ``test_env_nee_composes_with_sobol_and_fog`` and
  test_fog's ``test_fog_composes_with_mis_and_sobol`` on the port.
Left out: test_sobol's sharded step (ROADMAP Queue 1 item 13) and its slow
convergence checks."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tyrant_tpu import render as jr
from tyrant_tpu import sky as jsky
from tyrant_tpu.camera import Camera as JCamera
from tyrant_tpu.config import small_config as jsmall_config
from tyrant_tpu.ops import rng as jrng
from tyrant_tpu.ops import sobol as jsobol
from tyrant_tpu.ops.tonemap import resolve as jresolve
from tyrant_tpu.scene.scene import Scene as JScene
from tyrant_tpu.scene.scene import Spheres as JSpheres
from tyrant_tpu_torch import render as tr
from tyrant_tpu_torch import sky as tsky
from tyrant_tpu_torch.camera import Camera
from tyrant_tpu_torch.config import small_config
from tyrant_tpu_torch.ops import sobol
from tyrant_tpu_torch.ops.tonemap import resolve
from tyrant_tpu_torch.scene.scene import Scene, Spheres

from .test_torch_lights import SHADE_CASES as LIGHT_CASES
from .test_torch_lights import both, hot_envmap, pose, queue_and_shade

SUN = (0.05, 0.3)
EDGES = np.array([0, 1, 2, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFE, 0xFFFFFFFF],
                 np.uint64)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One PyTorch thread: beside the other test workers the default of a
    thread a core oversubscribes the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _u32s(n=20_000, seed=1):
    """The edge values, then random u32s, as uint32."""
    r = np.random.default_rng(seed)
    return np.concatenate([EDGES, r.integers(0, 1 << 32, n,
                                             dtype=np.uint64)]).astype(
        np.uint32)


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


# --------------------------------------------------------------------------
# the functions against JAX
# --------------------------------------------------------------------------

UNARY = ("reverse_bits32", "sobol_dim0", "sobol_dim1")
KEYED = ("laine_karras", "nested_uniform_scramble", "sample_2d", "sample_1d")


@pytest.mark.parametrize("name", UNARY + KEYED + ("_key_mix",))
def test_functions_bit_equal_to_jax(name):
    x = _u32s()
    keys = np.roll(_u32s(seed=2), 3)  # edge keys meet other edge values
    if name in UNARY:
        got = getattr(sobol, name)(_t(x))
        want = getattr(jsobol, name)(jnp.asarray(x))
    elif name == "_key_mix":
        got = [sobol._key_mix(_t(x), s) for s in (0xA511E9B3, 0x1D8E4464,
                                                  0x8C7F1A2B)]
        want = [jsobol._key_mix(jnp.asarray(x), s) for s in (0xA511E9B3,
                                                             0x1D8E4464,
                                                             0x8C7F1A2B)]
    else:
        got = getattr(sobol, name)(_t(x), _t(keys))
        want = getattr(jsobol, name)(jnp.asarray(x), jnp.asarray(keys))
    got = got if isinstance(got, (tuple, list)) else [got]
    want = want if isinstance(want, (tuple, list)) else [want]
    for g, w in zip(got, want):
        w = np.asarray(w)
        if w.dtype == np.float32:
            np.testing.assert_array_equal(g.numpy(), w)
            assert g.dtype == torch.float32
        else:
            np.testing.assert_array_equal(g.numpy(), w.astype(np.int64))
            assert g.dtype == torch.int64 and int(g.min()) >= 0 \
                and int(g.max()) <= 0xFFFFFFFF


def test_mul32_split_is_exact():
    """The split product against Python's big integers: no intermediate
    leaves int64 (the largest is below 2^48 + 2^32)."""
    x = _u32s(4000)
    for c in (0x6C50B47C, 0xB82F1E52, 0xC7AFE638, 0x8D22F6E6, 0x7FEB352D,
              0x846CA68B, 0xFFFFFFFF, 0x80000000):
        want = np.array([(int(v) * c) & 0xFFFFFFFF for v in x], np.int64)
        np.testing.assert_array_equal(sobol._mul32(_t(x), c).numpy(), want)


# --------------------------------------------------------------------------
# test_sobol's point-set checks on the port
# --------------------------------------------------------------------------

def test_elementary_intervals():
    """Shuffle and scramble keep the (0,2)-sequence property: each 2^k
    prefix puts one point in each elementary interval of area 2^-k."""
    for key_val in (1, 12345, 0xDEADBEEF):
        u, v = (a.numpy() for a in sobol.sample_2d(
            torch.arange(64), torch.full((64,), key_val)))
        for npts in (16, 64):
            for a in (1, 2, 4, npts):
                b = npts // a
                flat = (np.floor(u[:npts] * a).astype(int) * b
                        + np.floor(v[:npts] * b).astype(int))
                counts = np.bincount(flat, minlength=a * b)
                assert counts.max() == 1 and counts.min() == 1, \
                    (key_val, npts, a, b)


def test_1d_prefix_stratified():
    d = sobol.sample_1d(torch.arange(128), torch.full((128,), 5)).numpy()
    assert len(set(np.floor(d * 128).astype(int))) == 128
    assert d.min() >= 0.0 and d.max() < 1.0


def test_keys_decorrelate():
    idx = torch.arange(4096)
    u1, _ = sobol.sample_2d(idx, torch.full((4096,), 111))
    u2, _ = sobol.sample_2d(idx, torch.full((4096,), 222))
    c = np.corrcoef(u1.numpy(), u2.numpy())[0, 1]
    assert abs(c) < 0.1, c
    assert abs(float(u1.mean()) - 0.5) < 0.02


# --------------------------------------------------------------------------
# state, raygen, bookkeeping
# --------------------------------------------------------------------------

def _cfg(mode="sobol", num_rays=1 << 12, w=48, h=32, **kw):
    return small_config(width=w, height=h, num_rays=num_rays, sampler=mode,
                        **kw)


def _cluster(cls=Camera):
    cam = cls()
    cam.position = np.array([0.0, -170.0, 40.0], np.float32)
    cam.vertical_angle = -0.10
    return cam


def test_state_and_config_plumbing():
    st = tr.init_state(_cfg(), "cpu")
    assert st.sample_idx.shape == (1 << 12,)
    assert st.sample_base.shape == () and st.sample_idx.dtype == torch.int64
    assert tr.init_state(_cfg("xorshift"), "cpu").sample_idx.shape == (1,)
    with pytest.raises(ValueError):
        small_config(sampler="halton")
    with pytest.raises(ValueError):
        small_config(sampler="sobol", adaptive_sampling="on")


def test_sample_index_bookkeeping():
    """After 5 steps the counters account for the fresh rays of every
    step; a carried ray's sample index never passes the pass counter,
    and ``sample_base`` is the passes of the fresh rays generated."""
    cfg = _cfg(num_rays=1 << 10, w=16, h=16)
    r = tr.Renderer(Scene.load(None), cfg, device="cpu", sun_position=SUN)
    generated = 0
    for _ in range(5):
        generated += cfg.num_rays - int(r.state.n_carried)
        r.step(_cluster(), 1)
    total = 16 * 16
    gen_total = int(r.state.sample_base) * total + int(r.state.start_position)
    assert gen_total == generated
    assert int(r.state.sample_idx.max()) <= int(r.state.sample_base) + 1


@pytest.mark.parametrize("seed", [0, 7])
def test_raygen_matches_jax(seed):
    cfg = _cfg(w=32, h=24, num_rays=4096, seed=seed)
    jcfg = jsmall_config(width=32, height=24, num_rays=4096, sampler="sobol",
                         seed=seed)
    cam = _cluster()
    cam.lens_radius, cam.focal_distance = 0.8, 40.0
    jcam = _cluster(JCamera)
    jcam.lens_radius, jcam.focal_distance = 0.8, 40.0
    camt, camd = cam.to_device(cfg, "cpu"), jcam.to_device(jcfg)
    for start, base, frame in ((0, 0, 1), (517, 3, 9), (760, 0xFFFFFFFE, 5)):
        want = jr._raygen(jcfg, camd, jnp.int32(start), jnp.uint32(frame),
                          cfg.height, 0, sample_base=jnp.uint32(base))
        got = tr._raygen(cfg, camt, torch.tensor(start), torch.tensor(frame),
                         sample_base=torch.tensor(base))
        np.testing.assert_array_equal(got["pixel"].numpy(),
                                      np.asarray(want["pixel"]))
        np.testing.assert_array_equal(
            got["sample_idx"].numpy(),
            np.asarray(want["sample_idx"]).astype(np.int64))
        for k in ("origin", "direction"):
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       rtol=0, atol=1e-6 * (
                                           200 if k == "origin" else 1))


# --------------------------------------------------------------------------
# _shade under Sobol
# --------------------------------------------------------------------------

def _jax_draws(cfg, jrays):
    """The JAX _shade's sob1/sob2 (tyrant_tpu/render.py:1848-1860)."""
    s_idx = jrays["sample_idx"]
    salt = (cfg.seed,) if cfg.seed else ()

    def key(purpose):
        return jrng.seed_from(jrays["pixel"], 0,
                              jrays["bounces"] * 16 + purpose, *salt, 0x50B0)
    return (lambda p: jsobol.sample_1d(s_idx, key(p)),
            lambda p: jsobol.sample_2d(s_idx, key(p)))


def _sobol_picks(cfg, q):
    """The NEE light pick of both packages under Sobol on the queue, and
    the rays whose uniform lies within 2 ulp of a power-CDF entry."""
    td, rays, n = q["td"], q["rays"], cfg.num_rays
    o = np.zeros((n, 3), np.float32)
    nrm = np.tile(np.float32([0.0, 0.0, 1.0]), (n, 1))
    slot = np.arange(n)
    jrays = {k: jnp.asarray(v.numpy()) for k, v in rays.items()}
    jout = jr._shade_nee_samples(
        cfg, q["jd"], jsky.SkyParams(cfg.sky),
        jsky.sun_direction_from_position(jnp.asarray(SUN)), jrays,
        jnp.asarray(o), jnp.asarray(nrm), jnp.uint32(q["frame"]),
        jnp.asarray(slot, jnp.int32), 0, jnp.zeros(n, jnp.uint32), True,
        *_jax_draws(cfg, jrays), cfg.mis == "on")
    sob = tr._sobol_draws(cfg, rays)
    tout = tr._shade_nee_samples(
        cfg, td, tsky.SkyParams(cfg.sky),
        tsky.sun_direction_from_position(SUN, "cpu"), rays,
        torch.from_numpy(o), torch.from_numpy(nrm), torch.tensor(q["frame"]),
        torch.from_numpy(slot), torch.zeros(n, dtype=torch.int64), sob)
    lu = sob[0](4).numpy()
    cdf = td.light_cdf.numpy()[:-1]
    tie = (np.abs(lu[:, None] - cdf[None]) <= 2 * np.spacing(cdf)).any(1) \
        if cdf.size else np.zeros(n, bool)
    return np.asarray(jout[9]), tout["pick"].numpy(), tie


SOBOL_CASES = {
    "one_light": (dict(), {}),
    "power_cdf": LIGHT_CASES["power_cdf"],
    "power_alias": LIGHT_CASES["power_alias"],
    "env_mis_on": LIGHT_CASES["env_mis_on"],
    "fog_mis": (dict(n_tri=16, delta=True),
                dict(mis="on", fog="on", fog_sigma_s=0.02, fog_sigma_a=0.005,
                     fog_g=0.6, fog_z_min=-20.0, fog_z_max=60.0,
                     fog_falloff=0.05)),
    "seed": (dict(n_sphere_lights=3), dict(seed=7)),
}


@pytest.mark.parametrize("case", list(SOBOL_CASES))
def test_shade_matches_jax_under_sobol(case):
    kw, over = SOBOL_CASES[case]
    cfg = small_config(width=32, height=32, num_rays=4096, sampler="sobol",
                       **over)
    js, ts = both(**kw)
    q = queue_and_shade(js, ts, cfg, steps=3)
    tc, tsurv, tnext, tshadow = q["port"]
    jc, jsurv, jnext, jshadow = q["jax"]
    assert int(q["rays"]["sample_idx"].max()) >= 1  # past the first pass
    multi, total = tr._n_lights(q["td"])
    if multi:
        jpick, tpick, tie = _sobol_picks(cfg, q)
        assert tie.sum() <= 2, tie.sum()
        np.testing.assert_array_equal(tpick[~tie], jpick[~tie])
        assert np.unique(tpick).size >= min(total, 8)
    np.testing.assert_array_equal(tsurv.numpy(), np.asarray(jsurv))
    valid = tshadow["valid"].numpy()
    np.testing.assert_array_equal(valid, np.asarray(jshadow["valid"]))
    assert valid.sum() > 100
    close = dict(rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), **close)
    for k in ("origin", "direction", "direct"):
        np.testing.assert_allclose(tnext[k].numpy(), np.asarray(jnext[k]),
                                   err_msg=k, **close)
    for k in ("pixel", "bounces", "last_specular"):
        np.testing.assert_array_equal(tnext[k].numpy(),
                                      np.asarray(jnext[k]), err_msg=k)
    np.testing.assert_array_equal(
        tnext["sample_idx"].numpy(),
        np.asarray(jnext["sample_idx"]).astype(np.int64))
    if cfg.mis == "on":
        np.testing.assert_allclose(tnext["bsdf_pdf"].numpy(),
                                   np.asarray(jnext["bsdf_pdf"]), **close)
    for k in ("direction", "color", "max_dist"):
        np.testing.assert_allclose(tshadow[k].numpy()[valid],
                                   np.asarray(jshadow[k])[valid], err_msg=k,
                                   **close)


# --------------------------------------------------------------------------
# the Renderer
# --------------------------------------------------------------------------

def _carried(st):
    n = int(st.n_carried)
    return np.stack([np.asarray(st.pixel)[:n], np.asarray(st.bounces)[:n],
                     np.asarray(st.sample_idx)[:n].astype(np.int64)], 1)


@pytest.mark.parametrize("seed", [0, 5])
def test_renderers_agree_under_sobol(seed):
    """Both Renderers on the lights scene under Sobol: the same carried
    rays (pixel, bounce, sample index) in the same slots through step 4,
    the counters equal, then after step 6 the path counts on >= 99% of
    the pixels and the images within 0.01."""
    w = h = 32
    kw = dict(sampler="sobol", seed=seed)
    jren = jr.Renderer(both(n_sphere_lights=3)[0], jsmall_config(
        width=w, height=h, num_rays=4096, **kw), sun_position=SUN,
        donate=False)
    tren = tr.Renderer(both(n_sphere_lights=3)[1], small_config(
        width=w, height=h, num_rays=4096, **kw), device="cpu",
        sun_position=SUN)
    jren.step(pose(JCamera), 4)
    tren.step(pose(), 4)
    np.testing.assert_array_equal(_carried(tren.state), _carried(jren.state))
    for k in ("sample_base", "start_position", "frame", "n_carried"):
        assert int(getattr(tren.state, k)) == int(getattr(jren.state, k)), k
    jren.step(pose(JCamera), 2)
    tren.step(pose(), 2)
    ja, ta = np.asarray(jren.state.accum), tren.state.accum.numpy()
    assert np.isfinite(ta).all() and ja[:, 3].sum() > 0
    assert (ta[:, 3] == ja[:, 3]).mean() >= 0.99
    diff = np.abs(resolve(tren.state.accum, w, h).numpy()
                  - np.asarray(jresolve(jnp.asarray(ja), w, h)))
    assert diff.mean() < 0.01, diff.mean()


def _sphere_only(cls):
    """test_envlight's scene: the seven spheres' DIFF ground and two
    others, no light."""
    s = cls.default_seven()
    keep = np.array([0, 2, 3])
    return cls(center=s.center[keep], radius=s.radius[keep],
               color=s.color[keep], emission=np.zeros((3, 3), np.float32),
               refl=np.zeros(3, np.int32))


def test_env_nee_composes_with_sobol_and_fog():
    """test_envlight's case: env NEE under MIS with Sobol and fog."""
    scene = Scene.load(None, spheres=_sphere_only(Spheres),
                       envmap=hot_envmap())
    cfg = small_config(width=16, height=16, num_rays=1 << 11, mis="on",
                       sampler="sobol", fog="on", fog_sigma_s=0.004,
                       fog_z_max=60.0)
    r = tr.Renderer(scene, cfg, device="cpu")
    r.step(_cluster(), 6)
    a = r.state.accum.numpy()
    assert np.isfinite(a).all() and a[:, 3].sum() > 0


def test_fog_composes_with_mis_and_sobol():
    cfg = dataclasses.replace(
        small_config(width=24, height=24, num_rays=1 << 12),
        fog="on", fog_sigma_s=0.005, fog_g=0.2, fog_z_max=80.0, mis="on",
        sampler="sobol")
    r = tr.Renderer(Scene.load(None), cfg, device="cpu", sun_position=SUN)
    r.step(_cluster(), 6)
    acc = r.state.accum
    assert torch.isfinite(acc).all() and float(acc[:, 3].sum()) > 0
    assert float(resolve(acc, 24, 24).max()) > 0.05



@pytest.mark.parametrize("case,dispersion", [("materials", 0.0),
                                             ("ior", 0.05)])
def test_shade_matches_jax_under_sobol_materials(case, dispersion):
    """test_torch_materials' scenes (random DIFF/SPEC/REFR/PHONG/GGX/RREFR
    triangles, a GGX and an RREFR sphere, per-triangle IOR with
    dispersion) under Sobol: the bounce pair that DIFF, GGX and RREFR
    share (purpose 6), the glass coin (7) and the dispersion channel
    (13).  The queue is the port Renderer's after 3 steps; Russian
    roulette, shadow.valid and last_specular exact, the rest within
    1e-4."""
    from tyrant_tpu.scene.scene import Scene as JScene
    from tyrant_tpu.scene.scene import Spheres as JSpheres

    from .test_torch_materials import _material_scene
    cfg = small_config(width=32, height=32, num_rays=4096, sampler="sobol",
                       dispersion=dispersion)
    q = queue_and_shade(_material_scene(JScene, JSpheres, case),
                        _material_scene(Scene, Spheres, case), cfg, steps=3)
    tc, tsurv, tnext, tshadow = q["port"]
    jc, jsurv, jnext, jshadow = q["jax"]
    np.testing.assert_array_equal(tsurv.numpy(), np.asarray(jsurv))
    valid = tshadow["valid"].numpy()
    np.testing.assert_array_equal(valid, np.asarray(jshadow["valid"]))
    np.testing.assert_array_equal(tnext["last_specular"].numpy(),
                                  np.asarray(jnext["last_specular"]))
    close = dict(rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), **close)
    for k in ("origin", "direction", "direct"):
        np.testing.assert_allclose(tnext[k].numpy(), np.asarray(jnext[k]),
                                   err_msg=k, **close)
