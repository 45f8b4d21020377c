"""Height fog on the CPU, against the JAX package on the same numpy
inputs.

- The fog functions (``_fog_overlap``, ``_fog_density_coeffs``,
  ``_fog_optical_depth``, ``_fog_free_flight``) and ``hg_phase`` /
  ``hg_sample_from_uniforms`` against the JAX ones within rtol 2e-6 (the
  escapes of the free flight exact), and the checks of test_fog on the
  port's copies (quadrature, the inverse CDF, the slab cases, the phase's
  normalisation and mean cosine).
- ``_shade_fog_sample``: the medium events exact and their distances
  within rtol 2e-6; ``_shade`` against the JAX ``_shade`` with fog on a
  homogeneous slab, with height falloff, with MIS, with emissive
  triangles and delta lights (under a power pick, with and without MIS),
  with an environment map under MIS, and beside a cutout texture: the
  survivors, ``shadow.valid``, the next rays' integer fields and
  last_specular exact; colours, directions and throughputs within 1e-5,
  origins within 1e-4 (a few ulp of the 100-unit coordinates).
- A fog scene through both Renderers for 6 steps (the same slots through
  step 4, path counts on >= 99% of the pixels, images within 0.01), the
  zero-sigma gate (bit for bit the fog-off render), a pure absorber's
  transmittance against the analytic one, and fog composed with MIS.
  Left out: test_fog's Sobol composition and sharded step (ROADMAP Queue
  1 items 9 and 13) and its slow oracle comparison."""

import dataclasses
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tyrant_tpu import render as jr
from tyrant_tpu import sky as jsky
from tyrant_tpu.camera import Camera as JCamera
from tyrant_tpu.config import small_config as jsmall_config
from tyrant_tpu.ops import sampling as jsampling
from tyrant_tpu.ops.tonemap import resolve as jresolve
from tyrant_tpu.scene.scene import DeltaLights as JDeltaLights
from tyrant_tpu.scene.scene import Scene as JScene
from tyrant_tpu_torch import render as tr
from tyrant_tpu_torch import sky as tsky
from tyrant_tpu_torch.camera import Camera
from tyrant_tpu_torch.config import VERY_FAR, small_config
from tyrant_tpu_torch.ops import sampling as tsampling
from tyrant_tpu_torch.ops.tonemap import resolve
from tyrant_tpu_torch.scene.procgen import terrain
from tyrant_tpu_torch.scene.scene import DeltaLights, Scene

from .test_torch_lights import DELTA_SPECS, hot_envmap

SUN = (0.05, 0.3)
W = H = 24
RTOL = 2e-6
FOG = dict(fog="on", fog_sigma_s=0.02, fog_sigma_a=0.005, fog_g=0.6,
           fog_z_min=-20.0, fog_z_max=60.0)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One PyTorch thread: beside the other test workers the default of a
    thread a core oversubscribes the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _rays(n, seed):
    r = np.random.default_rng(seed)
    o = r.uniform(-30, 90, (n, 3)).astype(np.float32)
    d = r.normal(size=(n, 3))
    d[:8, 2] = 0.0  # parallel to the slab
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return o, d


# --------------------------------------------------------------------------
# the fog functions and the phase function against JAX
# --------------------------------------------------------------------------

def test_fog_functions_match_jax():
    n = 4096
    o, d = _rays(n, 1)
    r = np.random.default_rng(2)
    t_lim = np.where(r.random(n) < 0.3, np.float32(VERY_FAR),
                     r.uniform(0, 150, n)).astype(np.float32)
    ta_j, ln_j = jr._fog_overlap(jnp.asarray(o), jnp.asarray(d),
                                 jnp.asarray(t_lim), -20.0, 60.0)
    ta_t, ln_t = tr._fog_overlap(_t(o), _t(d), _t(t_lim), -20.0, 60.0)
    np.testing.assert_allclose(ta_t.numpy(), np.asarray(ta_j), rtol=RTOL)
    np.testing.assert_allclose(ln_t.numpy(), np.asarray(ln_j), rtol=RTOL,
                               atol=1e-5)
    assert (ln_t.numpy() > 0).mean() > 0.3
    for lam in (0.05, -0.02):
        rj, kj = jr._fog_density_coeffs(jnp.asarray(o), jnp.asarray(d),
                                        ta_j, lam)
        rt, kt = tr._fog_density_coeffs(_t(o), _t(d), ta_t, lam)
        np.testing.assert_allclose(rt.numpy(), np.asarray(rj), rtol=1e-5)
        np.testing.assert_allclose(kt.numpy(), np.asarray(kj), rtol=RTOL)
        tau_j = jr._fog_optical_depth(0.025, rj, kj, ln_j)
        tau_t = tr._fog_optical_depth(0.025, rt, kt, ln_t)
        np.testing.assert_allclose(tau_t.numpy(), np.asarray(tau_j),
                                   rtol=2e-5, atol=1e-7)
        u = r.uniform(0, 1, n).astype(np.float32)
        rj0, kj0 = jr._fog_density_coeffs(jnp.asarray(o), jnp.asarray(d),
                                          jnp.zeros(n), lam)
        rt0, kt0 = tr._fog_density_coeffs(_t(o), _t(d), torch.zeros(n),
                                          lam)
        sj = np.asarray(jr._fog_free_flight(jnp.asarray(u), 0.025, rj0, kj0))
        st = tr._fog_free_flight(_t(u), 0.025, rt0, kt0).numpy()
        np.testing.assert_array_equal(st >= 1e19, sj >= 1e19)
        np.testing.assert_allclose(st, sj, rtol=1e-5)


@pytest.mark.parametrize("g", [0.0, 0.6, -0.45])
def test_hg_matches_jax(g):
    r = np.random.default_rng(3)
    n = 4096
    c = r.uniform(-1, 1, n).astype(np.float32)
    np.testing.assert_allclose(tsampling.hg_phase(_t(c), g).numpy(),
                               np.asarray(jsampling.hg_phase(
                                   jnp.asarray(c), g)), rtol=RTOL)
    _, d = _rays(n, 4)
    u1, u2 = (r.random(n).astype(np.float32) for _ in range(2))
    got = tsampling.hg_sample_from_uniforms(_t(d), g, _t(u1), _t(u2))
    want = jsampling.hg_sample_from_uniforms(jnp.asarray(d), g,
                                             jnp.asarray(u1), jnp.asarray(u2))
    # sin(theta) = sqrt(1 - cos^2) loses digits near the poles
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


# --------------------------------------------------------------------------
# test_fog's checks on the port's functions
# --------------------------------------------------------------------------

def test_fog_optical_depth_matches_quadrature():
    rng = np.random.default_rng(3)
    n, lam, sigma_t = 64, 0.13, 0.7
    o = rng.uniform(-10, 10, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3))
    d[:5, 2] = 0.0
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    ta = rng.uniform(0, 4, n).astype(np.float32)
    s = rng.uniform(0.1, 12, n).astype(np.float32)
    rho0, k = tr._fog_density_coeffs(_t(o), _t(d), _t(ta), lam)
    tau = tr._fog_optical_depth(sigma_t, rho0, k, _t(s)).numpy()
    grid = np.linspace(0, 1, 4001)
    for i in range(n):
        tt = float(ta[i]) + grid * float(s[i])
        ref = sigma_t * np.trapezoid(np.exp(-lam * (o[i, 2] + d[i, 2] * tt)),
                                     tt)
        assert abs(tau[i] - ref) < 2e-3 * max(ref, 1.0), (i, tau[i], ref)


def test_fog_free_flight_inverts_optical_depth():
    rng = np.random.default_rng(5)
    n, lam, sigma_t = 512, 0.21, 0.35
    o = rng.uniform(-8, 8, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3))
    d[:8, 2] = 0.0
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    u = rng.uniform(1e-4, 1 - 1e-4, n).astype(np.float32)
    rho0, k = tr._fog_density_coeffs(_t(o), _t(d), torch.zeros(n), lam)
    s = tr._fog_free_flight(_t(u), sigma_t, rho0, k).numpy()
    e = -np.log1p(-u)
    kn = k.numpy()
    total = np.where(kn > 1e-12, sigma_t * rho0.numpy()
                     / np.maximum(kn, 1e-12), np.inf)
    esc = s >= 1e19
    np.testing.assert_array_equal(esc, total < e)
    tau_s = tr._fog_optical_depth(sigma_t, rho0, k, _t(s)).numpy()[~esc]
    np.testing.assert_allclose(tau_s, e[~esc], rtol=2e-3, atol=1e-5)


@pytest.mark.parametrize("g", [0.0, 0.4, -0.7])
def test_hg_phase_normalized(g):
    c = torch.linspace(-1.0, 1.0, 20001, dtype=torch.float64)
    vals = tsampling.hg_phase(c, g).numpy()
    assert abs(2.0 * math.pi * np.trapezoid(vals, c.numpy()) - 1.0) < 1e-3


@pytest.mark.parametrize("g", [0.0, 0.5, -0.4])
def test_hg_sample_matches_phase(g):
    n = 200_000
    rng = np.random.default_rng(7)
    d0 = np.float32([0.26726124, 0.53452248, 0.80178373])
    out = tsampling.hg_sample_from_uniforms(
        _t(np.tile(d0, (n, 1))), g, _t(rng.random(n).astype(np.float32)),
        _t(rng.random(n).astype(np.float32))).numpy()
    assert np.allclose(np.linalg.norm(out, axis=1), 1.0, atol=1e-4)
    assert abs(float((out @ d0).mean()) - g) < 0.01


def test_slab_overlap_cases():
    o = np.float32([[0, 0, 5], [0, 0, 5], [0, 0, 50], [0, 0, 5], [0, 0, -5],
                    [0, 0, 5]])
    d = np.float32([[0, 0, 1], [0, 0, 1], [1, 0, 0], [1, 0, 0], [1, 0, 0],
                    [0, 0, -1]])
    t_lim = np.float32([1e20, 2.0, 1e20, 7.0, 1e20, 1e20])
    ta, ln = (a.numpy() for a in tr._fog_overlap(_t(o), _t(d), _t(t_lim),
                                                 0.0, 10.0))
    np.testing.assert_allclose(ta[ln > 0], 0.0, atol=1e-5)
    np.testing.assert_allclose(ln, [5, 2, 0, 7, 0, 5], rtol=1e-5)
    ta2, ln2 = tr._fog_overlap(_t(np.float32([[0, 0, 20]])),
                               _t(np.float32([[0, 0, -1]])),
                               _t(np.float32([1e20])), 0.0, 10.0)
    np.testing.assert_allclose(ta2.numpy(), [10.0], rtol=1e-5)
    np.testing.assert_allclose(ln2.numpy(), [10.0], rtol=1e-5)


# --------------------------------------------------------------------------
# _shade against the JAX _shade
# --------------------------------------------------------------------------

def fog_scene(cls, dl_cls=None, n_tri=0, delta=False, envmap=None,
              cutout=False, spheres=None):
    """A small terrain under the seven spheres (or ``spheres``), ``n_tri``
    of its triangles emissive, the delta lights of test_torch_lights, an
    envmap, or a cutout texture on half of it."""
    v0, v1, v2 = terrain(n_quads=12, towers=2)
    t = v0.shape[0]
    kw = {} if spheres is None else dict(spheres=spheres)
    if n_tri:
        refl = np.zeros(t, np.int32)
        color = np.full((t, 3), 0.8, np.float32)
        lit = np.arange(n_tri) * (t // n_tri)
        refl[lit] = 4
        color[lit] = (3.0, 2.5, 2.0)
        kw.update(tri_refl=refl, tri_color=color)
    if delta:
        kw["delta_lights"] = dl_cls.from_specs(DELTA_SPECS)
    if envmap is not None:
        kw["envmap"] = envmap
    if cutout:
        tex = np.ones((8, 8, 4), np.float32)
        tex[::2, :, 3] = 0.0
        uv = np.stack([v[:, :2] / 25.0 for v in (v0, v1, v2)], 1)
        kw.update(textures=[tex], tri_uv=uv.astype(np.float32),
                  tri_tex=np.where(np.arange(t) % 2 == 0, 0, -1)
                  .astype(np.int32))
    return cls.from_triangles(v0, v1, v2, builder="numpy", **kw)


def pose(cls=Camera):
    cam = cls()
    cam.position = np.array([0.0, -140.0, 40.0], np.float32)
    cam.vertical_angle = -0.2
    return cam


SHADE_CASES = {
    "slab": ({}, {}),
    "falloff": ({}, dict(fog_falloff=0.05)),
    "mis": ({}, dict(mis="on", fog_falloff=0.05)),
    "tri_delta_power": (dict(n_tri=16, delta=True),
                        dict(light_sampling="power", fog_falloff=0.05)),
    "tri_delta_mis": (dict(n_tri=16, delta=True),
                      dict(light_sampling="power", mis="on")),
    "env_mis": (dict(envmap=hot_envmap()), dict(mis="on")),
    "cutout": (dict(cutout=True), dict(fog_falloff=0.05)),
}


@pytest.mark.parametrize("case", list(SHADE_CASES))
def test_shade_matches_jax(case):
    skw, over = SHADE_CASES[case]
    cfg = small_config(width=32, height=32, num_rays=4096,
                       **dict(FOG, **over))
    js = fog_scene(JScene, JDeltaLights, **skw)
    ts = fog_scene(Scene, DeltaLights, **skw)
    tren = tr.Renderer(ts, cfg, device="cpu", sun_position=SUN)
    tren.step(pose(), 3)
    td = tren.scene
    rays = tr.merge_queue(cfg, tren.state, tren._last_cam)
    jd = js.to_device()
    jrays = {k: jnp.asarray(v.numpy()) for k, v in rays.items()}
    jt, jid, jtri, _ = jr._intersect_scene(jrays["origin"],
                                           jrays["direction"], jd)
    frame = int(tren.state.frame)
    # the medium events exact, their distances within rtol 2e-6
    slot = torch.arange(cfg.num_rays)
    t_port, fog_port = tr._shade_fog_sample(cfg, rays, _t(np.array(jt)),
                                            torch.tensor(frame), slot)
    t_jax, fog_jax = jr._shade_fog_sample(
        cfg, jrays, jt, jnp.uint32(frame),
        jnp.arange(cfg.num_rays, dtype=jnp.int32), 0)
    np.testing.assert_array_equal(fog_port.numpy(), np.asarray(fog_jax))
    assert 50 < int(fog_port.sum()) < cfg.num_rays
    np.testing.assert_allclose(t_port.numpy(), np.asarray(t_jax), rtol=RTOL)

    jc, _, jsurv, jnext, jshadow = jr._shade(
        cfg, jd, jsky.SkyParams(cfg.sky),
        jsky.sun_direction_from_position(jnp.asarray(SUN)), jrays,
        jt, jid, jtri, jnp.uint32(frame))
    tc, tsurv, tnext, tshadow = tr._shade(
        cfg, td, tsky.SkyParams(cfg.sky), tren.sun_dir, rays,
        _t(np.array(jt)), _t(np.array(jid)), _t(np.array(jtri)),
        torch.tensor(frame))
    np.testing.assert_array_equal(tsurv.numpy(), np.asarray(jsurv))
    valid = tshadow["valid"].numpy()
    np.testing.assert_array_equal(valid, np.asarray(jshadow["valid"]))
    assert (valid & fog_port.numpy()).sum() > 20
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-5,
                               atol=1e-5)
    # the origins within a few ulp of the scene's 100-unit coordinates
    # (a medium event's point is o + d (t_enter + s)), the directions
    # within 1e-5 (the HG sample's sin near the poles)
    for k, tol in (("origin", 1e-4), ("direction", 1e-5), ("direct", 1e-5)):
        np.testing.assert_allclose(tnext[k].numpy(), np.asarray(jnext[k]),
                                   rtol=1e-5, atol=tol, err_msg=k)
    for k in ("pixel", "bounces", "last_specular"):
        np.testing.assert_array_equal(tnext[k].numpy(),
                                      np.asarray(jnext[k]), err_msg=k)
    if cfg.mis == "on":
        np.testing.assert_allclose(tnext["bsdf_pdf"].numpy(),
                                   np.asarray(jnext["bsdf_pdf"]), rtol=1e-5,
                                   atol=1e-5)
    for k in ("direction", "color", "max_dist"):
        np.testing.assert_allclose(tshadow[k].numpy()[valid],
                                   np.asarray(jshadow[k])[valid], rtol=1e-5,
                                   atol=1e-5, err_msg=k)


# --------------------------------------------------------------------------
# the Renderer
# --------------------------------------------------------------------------

def carried(st):
    n = int(st.n_carried)
    return np.stack([np.asarray(st.pixel)[:n], np.asarray(st.bounces)[:n]],
                    1)


@pytest.mark.parametrize("falloff", [0.0, 0.05])
def test_fog_scene_renders_like_jax(falloff):
    """A fog scene through both Renderers: the same carried rays in the
    same slots through step 4, then after step 6 the per-pixel path
    counts on >= 99% of the pixels (100% measured) and the images within
    0.01.  The scene has the seven spheres but the ground sphere, whose
    roots differ from XLA's by up to 1e-3 (ROADMAP Queue 3): with it, a
    medium event whose free flight ends within that of its surface flips
    by step 3 under height falloff, and the sort moves the rays after it
    to other slots.  The medium events on the same inputs are exact
    (test_shade_matches_jax)."""
    from tyrant_tpu.scene.scene import Spheres as JSpheres

    from tyrant_tpu_torch.scene.scene import Spheres

    from .test_torch_textures import _spheres
    w = h = 32
    fog = dict(FOG, fog_falloff=falloff)
    cfg = small_config(width=w, height=h, num_rays=4096, **fog)
    jcfg = jsmall_config(width=w, height=h, num_rays=4096, **fog)
    jren = jr.Renderer(fog_scene(JScene, spheres=_spheres(JSpheres)), jcfg,
                       sun_position=SUN, donate=False)
    tren = tr.Renderer(fog_scene(Scene, spheres=_spheres(Spheres)), cfg,
                       device="cpu", sun_position=SUN)
    jren.step(pose(JCamera), 4)
    tren.step(pose(), 4)
    np.testing.assert_array_equal(carried(tren.state), carried(jren.state))
    jren.step(pose(JCamera), 2)
    tren.step(pose(), 2)
    ja, ta = np.asarray(jren.state.accum), tren.state.accum.numpy()
    assert np.isfinite(ta).all() and ja[:, 3].sum() > 0
    assert (ta[:, 3] == ja[:, 3]).mean() >= 0.99
    diff = np.abs(resolve(tren.state.accum, w, h).numpy()
                  - np.asarray(jresolve(jnp.asarray(ja), w, h)))
    assert diff.mean() < 0.01, diff.mean()


def cluster_camera():
    cam = Camera()
    cam.position = np.array([0.0, -170.0, 40.0], np.float32)
    cam.vertical_angle = -0.10
    return cam


def _render(cfg, steps=8, cam=None):
    r = tr.Renderer(Scene.load(None), cfg, device="cpu", sun_position=SUN)
    r.step(cam or cluster_camera(), steps)
    return r.state.accum.numpy().copy()


def test_zero_sigma_is_noop():
    base = small_config(width=W, height=H, num_rays=1 << 12)
    a = _render(dataclasses.replace(base, fog="off"))
    b = _render(dataclasses.replace(base, fog="on", fog_sigma_s=0.0,
                                    fog_sigma_a=0.0))
    np.testing.assert_array_equal(a, b)


def test_pure_absorption_attenuates_sky():
    """test_fog: looking up from inside an absorbing slab, each path
    reaches the sky with probability exp(-sigma_a L)."""
    sigma, z_top = 0.03, 90.0
    cam = cluster_camera()
    cam.vertical_angle = 1.2
    cam.horizontal_angle = math.pi
    base = small_config(width=W, height=H, num_rays=1 << 13)
    clear = _render(dataclasses.replace(base, fog="off"), 20, cam)
    fog = _render(dataclasses.replace(
        base, fog="on", fog_sigma_s=0.0, fog_sigma_a=sigma, fog_z_min=0.0,
        fog_z_max=z_top), 20, cam)
    right, up = cam.basis(base)
    pix = np.arange(W * H)
    ni = ((pix % W) + 0.5) / W - 0.5
    nj = (H - ((pix // W) + 0.5)) / H - 0.5
    dirs = cam.direction[None] + ni[:, None] * right[None] \
        + nj[:, None] * up[None]
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    expect = np.exp(-sigma * (z_top - 40.0) / dirs[:, 2])
    ratio = ((fog[:, :3].mean(1) / np.maximum(fog[:, 3], 1))
             / np.maximum(clear[:, :3].mean(1) / clear[:, 3], 1e-12)).mean()
    assert abs(ratio - expect.mean()) < 0.05 * expect.mean()


def test_fog_composes_with_mis():
    """test_fog's composition case without Sobol (ROADMAP item 9)."""
    cfg = dataclasses.replace(
        small_config(width=W, height=H, num_rays=1 << 12),
        fog="on", fog_sigma_s=0.005, fog_g=0.2, fog_z_max=80.0, mis="on")
    acc = _render(cfg, steps=6)
    assert np.isfinite(acc).all() and acc[:, 3].sum() > 0
    img = resolve(torch.from_numpy(acc), W, H).numpy()
    assert img.max() > 0.05
