"""Adaptive sampling, the second moments and the step's ``seed`` and
``radiance_clamp`` on the CPU, against the JAX package on the same numpy
inputs.

- ``build_perm`` in its three stages: the weights within 1e-3 of the
  mean weight of the JAX ones (XLA's FMA keeps a residue where a
  variance cancels); the integer weights ``wq`` (quantised by a float32
  sum that XLA and PyTorch reduce in other orders) equal but for at most
  1 entry in 1000, each off by 1 (0 measured, 1080p included); and, fed
  the JAX ``wq``, the perm exactly the JAX one.
- ``mean_relative_error`` and ``Renderer.noise_estimate`` within 1e-6
  relative of the JAX ones on the same moments.
- One render step from a JAX state under ``track_variance``, ``seed`` and
  ``radiance_clamp`` against the JAX step: the carried rays, the path
  counts and the moments' counts exact, the sums within 1e-4.
- test_adaptive without its sharded and CLI cases, on the port."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tyrant_tpu import adaptive as jad
from tyrant_tpu import render as jr
from tyrant_tpu import sky as jsky
from tyrant_tpu.camera import Camera as JCamera
from tyrant_tpu.config import small_config as jsmall_config
from tyrant_tpu.scene.scene import Scene as JScene
from tyrant_tpu_torch import adaptive as tad
from tyrant_tpu_torch import interop
from tyrant_tpu_torch import render as tr
from tyrant_tpu_torch import sky as tsky
from tyrant_tpu_torch.camera import Camera
from tyrant_tpu_torch.config import small_config
from tyrant_tpu_torch.scene.scene import Scene

from .test_torch_lights import both, pose

SUN = (0.05, 0.3)
WQ_DIFF_PER_1000 = 1  # the wq entries allowed to differ (by 1) a 1000


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One PyTorch thread: beside the other test workers the default of a
    thread a core oversubscribes the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(adaptive="on", **kw):
    return small_config(width=32, height=32, num_rays=1 << 12,
                        adaptive_sampling=adaptive, **kw)


def _plane(cls=Scene):
    """test_adaptive's ground plane, two triangles facing up."""
    v0 = np.array([[-200, -200, 0], [200, 200, 0]], np.float32)
    v1 = np.array([[200, -200, 0], [-200, 200, 0]], np.float32)
    v2 = np.array([[-200, 200, 0], [200, -200, 0]], np.float32)
    n = np.cross(v1 - v0, v2 - v0)
    flip = n[:, 2] < 0
    v1[flip], v2[flip] = v2[flip].copy(), v1[flip].copy()
    return cls.from_triangles(v0, v1, v2, builder="numpy")


def _camera():
    cam = Camera()
    cam.position = np.array([0.0, 0.0, 50.0], np.float32)
    cam.vertical_angle = -1.2
    return cam


def _t(a):
    return torch.from_numpy(np.array(a))


# --------------------------------------------------------------------------
# build_perm in stages, mean_relative_error
# --------------------------------------------------------------------------

@jax.jit
def _jax_wq(accum, moment2, gamma=1.0):
    """The JAX build_perm's weights and integer weights
    (tyrant_tpu/adaptive.py:72-92), which it does not return."""
    p = accum.shape[0]
    cnt = accum[:, 3]
    n = jnp.maximum(cnt, 1.0)
    mean = accum[:, :3] / n[:, None]
    m2 = moment2[:, :3] / n[:, None]
    var = jnp.maximum(m2 - mean * mean, 0.0).sum(axis=1)
    lum = mean @ jnp.asarray([0.299, 0.587, 0.114], jnp.float32)
    err = jnp.sqrt(var / n) / (lum + 0.05)
    emax = jnp.max(jnp.where(cnt >= 1.0, err, 0.0))
    err = jnp.where(cnt < 1.0, jnp.maximum(emax, 1e-6), err)
    ebar = jnp.mean(err) + 1e-12
    err = err + ebar * jax.lax.rsqrt(n)
    w = jnp.power(err + 0.25 * ebar, gamma)
    wq = jnp.maximum((w * (16.0 * p / (jnp.sum(w) + 1e-30)))
                     .astype(jnp.int32), 1)
    return w, wq


@jax.jit
def _jax_perm_from_wq(wq, phase):
    """tyrant_tpu/adaptive.py:93-97 on a given wq."""
    p = wq.shape[0]
    cdf = jnp.cumsum(wq)
    stride = cdf[-1].astype(jnp.float32) / p
    targets = ((jnp.arange(p, dtype=jnp.float32) + phase) * stride) \
        .astype(jnp.int32)
    return jnp.clip(jnp.searchsorted(cdf, targets, side="right"), 0,
                    p - 1).astype(jnp.int32)


def _moments_case(name):
    """accum, moment2 [P, 4] float32: synthetic cases of test_adaptive and
    the moments of a real render."""
    r = np.random.default_rng(len(name))
    if name == "render":
        ren = jr.Renderer(_plane(JScene), jsmall_config(
            width=64, height=48, num_rays=1 << 12, track_variance="on"),
            donate=False)
        cam = JCamera()
        cam.position = np.array([0.0, 0.0, 50.0], np.float32)
        cam.vertical_angle = -1.2
        ren.step(cam, 5)
        return np.asarray(ren.state.accum), np.asarray(ren.state.moment2)
    p = 1920 * 1080 if name == "random_1080p" else 4096
    cnt = r.integers(0, 12, p).astype(np.float32)
    mean = r.uniform(0, 2, (p, 3)).astype(np.float32)
    accum = np.concatenate([mean * cnt[:, None], cnt[:, None]], 1)
    m2 = np.concatenate([(mean ** 2 + r.uniform(0, 3, (p, 3)))
                         * cnt[:, None], cnt[:, None]], 1)
    if name == "unsampled":
        accum[::7] = 0.0
        m2[::7] = 0.0
    return accum.astype(np.float32), m2.astype(np.float32)


@pytest.mark.parametrize("name,gamma,phase", [("random", 1.0, 0.0),
                                              ("unsampled", 0.5, 0.618034),
                                              ("render", 1.0, 0.236068),
                                              ("random_1080p", 1.0, 0.854102)])
def test_build_perm_stages_match_jax(name, gamma, phase):
    accum, m2 = _moments_case(name)
    p = accum.shape[0]
    jw, jwq = (np.asarray(x) for x in _jax_wq(jnp.asarray(accum),
                                              jnp.asarray(m2), gamma))
    jperm = np.asarray(_jax_perm_from_wq(jnp.asarray(jwq),
                                         jnp.float32(phase)))
    # the copy of the JAX stages is the JAX build_perm
    np.testing.assert_array_equal(jperm, np.asarray(jad.build_perm(
        jnp.asarray(accum), jnp.asarray(m2), jnp.asarray(phase, jnp.float32),
        gamma=gamma)))
    w = tad.perm_weights(_t(accum), _t(m2), gamma)
    # XLA contracts m2 - mean * mean into an FMA: where a pixel's variance
    # cancels in float32 (one path: m2 = mean^2), the JAX error keeps the
    # product's rounding residue and PyTorch's is 0, which moves that
    # weight by up to ~3e-4 of the mean weight (the "render" case)
    assert np.abs(w.numpy() - jw).max() <= 1e-3 * jw.mean()
    wq = tad.quantize_weights(w).numpy()
    diff = wq != jwq
    assert diff.sum() <= WQ_DIFF_PER_1000 * max(p // 1000, 1), diff.sum()
    assert (np.abs(wq - jwq) <= 1).all()
    ph = torch.tensor(phase, dtype=torch.float32)
    np.testing.assert_array_equal(tad.perm_from_wq(_t(jwq), ph).numpy(),
                                  jperm)
    perm = tad.build_perm(_t(accum), _t(m2), ph, gamma).numpy()
    assert perm.dtype == np.int32 and (np.diff(perm) >= 0).all()
    assert ((perm >= 0) & (perm < p)).all()


@pytest.mark.parametrize("name", ["random", "unsampled", "render"])
def test_mean_relative_error_matches_jax(name):
    accum, m2 = _moments_case(name)
    got = float(tad.mean_relative_error(_t(accum), _t(m2)))
    want = float(jad.mean_relative_error(jnp.asarray(accum), jnp.asarray(m2)))
    assert got > 0 and abs(got - want) <= 1e-6 * want, (got, want)


def test_noise_estimate_matches_jax():
    """The port's Renderer on the JAX Renderer's state (through interop):
    noise_estimate() within 1e-6 relative."""
    jren = jr.Renderer(_plane(JScene), jsmall_config(
        width=32, height=32, num_rays=1 << 12, track_variance="on"),
        donate=False)
    cam = JCamera()
    cam.position = np.array([0.0, 0.0, 50.0], np.float32)
    cam.vertical_angle = -1.2
    jren.step(cam, 6)
    tren = tr.Renderer(_plane(), _cfg("off", track_variance="on"),
                       device="cpu")
    tren.state = interop.state_from_numpy(
        {k: np.asarray(getattr(jren.state, k)) for k in interop.STATE_FIELDS},
        "cpu")
    got, want = tren.noise_estimate(), jren.noise_estimate()
    assert abs(got - want) <= 1e-6 * want, (got, want)


# --------------------------------------------------------------------------
# one step against the JAX step
# --------------------------------------------------------------------------

STEP_CASES = {"track_variance": dict(track_variance="on"),
              "seed": dict(seed=12345, track_variance="on"),
              "radiance_clamp": dict(radiance_clamp=0.5),
              "adaptive": dict(adaptive_sampling="on", raygen_order="scan")}


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_step_matches_jax(case):
    kw = STEP_CASES[case]
    cfg = small_config(width=32, height=32, num_rays=4096, **kw)
    jcfg = jsmall_config(width=32, height=32, num_rays=4096, **kw)
    js, ts = both(n_sphere_lights=3)
    jd = js.to_device()
    camd = pose(JCamera).to_device(jcfg)
    jsun = jsky.sun_direction_from_position(jnp.asarray(SUN))
    st = jr.init_state(jcfg)
    for _ in range(3):
        st = jr.render_step(st, jd, camd, jsun, cfg=jcfg)
    if cfg.adaptive_sampling == "on":
        st = dataclasses.replace(st, pixel_perm=jad.build_perm(
            st.accum, st.moment2, jnp.float32(0.3)))
    fields = {k: np.asarray(getattr(st, k)) for k in interop.STATE_FIELDS}
    tren = tr.Renderer(ts, cfg, device="cpu", sun_position=SUN)
    jst = jr.render_step(st, jd, camd, jsun, cfg=jcfg)
    tst = tr.render_step(interop.state_from_numpy(fields, "cpu"), tren.scene,
                         pose().to_device(cfg, "cpu"), tren.sun_dir, cfg=cfg,
                         tables=tren.tables)
    n = int(jst.n_carried)
    assert int(tst.n_carried) == n and n > 0
    for k in ("pixel", "bounces", "last_specular"):
        np.testing.assert_array_equal(getattr(tst, k).numpy()[:n],
                                      np.asarray(getattr(jst, k))[:n])
    for k in ("frame", "start_position", "shadow_rays"):
        assert int(getattr(tst, k)) == int(getattr(jst, k)), k
    ja, ta = np.asarray(jst.accum), tst.accum.numpy()
    np.testing.assert_array_equal(ta[:, 3], ja[:, 3])
    np.testing.assert_allclose(ta, ja, rtol=1e-4, atol=1e-4)
    if tr._moments(cfg):
        jm, tm = np.asarray(jst.moment2), tst.moment2.numpy()
        assert tm.shape == (cfg.num_pixels, 4)
        np.testing.assert_array_equal(tm[:, 3], jm[:, 3])
        np.testing.assert_array_equal(tm[:, 3], ta[:, 3])
        np.testing.assert_allclose(tm, jm, rtol=1e-4, atol=1e-4)
    else:
        assert tst.moment2.shape == (1, 4)
    if cfg.radiance_clamp:
        # a bounce adds at most the clamp a channel: the pending radiance
        # of a ray finished after b bounces is below (b + 1) * clamp
        pend = tst.pending.numpy()
        bounces = tst.bounces.numpy()
        assert (pend <= (bounces[:, None] + 1) * cfg.radiance_clamp
                + 1e-6).all()
    if case == "seed":
        # the salted frame re-keys every stream: another step than seed 0
        plain = tr.render_step(interop.state_from_numpy(fields, "cpu"),
                               tren.scene, pose().to_device(cfg, "cpu"),
                               tren.sun_dir, cfg=dataclasses.replace(
                                   cfg, seed=0), tables=tren.tables)
        assert not torch.equal(plain.direction, tst.direction)


# --------------------------------------------------------------------------
# test_adaptive on the port
# --------------------------------------------------------------------------

def test_state_dummies_when_off():
    st = tr.init_state(_cfg("off"), "cpu")
    assert st.moment2.shape == (1, 4)
    assert st.pixel_perm.shape == (1,)


def test_state_buffers_when_on():
    cfg = _cfg("on")
    st = tr.init_state(cfg, "cpu")
    p = cfg.width * cfg.height
    assert st.moment2.shape == (p, 4)
    np.testing.assert_array_equal(st.pixel_perm.numpy(), np.arange(p))


def test_moment2_tracks_counts_and_cauchy_schwarz():
    r = tr.Renderer(_plane(), _cfg("on"), device="cpu")
    r.step(_camera(), 6)
    accum = r.state.accum.numpy().astype(np.float64)
    m2 = r.state.moment2.numpy().astype(np.float64)
    np.testing.assert_array_equal(accum[:, 3], m2[:, 3])
    n = accum[:, 3:4]
    assert (n * m2[:, :3] >= accum[:, :3] ** 2 * (1 - 1e-5) - 1e-6).all()
    assert (m2 >= 0).all()


def test_adaptive_matches_uniform_before_first_rebuild():
    ra = tr.Renderer(_plane(), _cfg("on", raygen_order="scan",
                                    adaptive_interval=1000), device="cpu")
    ru = tr.Renderer(_plane(), _cfg("off", raygen_order="scan"),
                     device="cpu")
    ra.step(_camera(), 4)
    ru.step(_camera(), 4)
    assert torch.equal(ra.state.accum, ru.state.accum)


def _flat_moments(p, cnt):
    accum = np.zeros((p, 4), np.float32)
    m2 = np.zeros((p, 4), np.float32)
    accum[:, 3] = cnt
    m2[:, 3] = cnt
    accum[:, :3] = cnt / 2.0  # mean 0.5
    m2[:, :3] = cnt / 4.0  # zero variance
    return accum, m2


def _perm(accum, m2):
    return tad.build_perm(_t(accum), _t(m2), torch.tensor(0.0)).numpy()


def test_build_perm_prioritises_high_variance():
    p = 256
    accum, m2 = _flat_moments(p, 8.0)
    noisy = np.arange(16) * 16
    m2[noisy, :3] = 8.0
    perm = _perm(accum, m2)
    assert perm.shape == (p,) and ((perm >= 0) & (perm < p)).all()
    assert (np.diff(perm) >= 0).all()
    counts = np.bincount(perm, minlength=p)
    quiet = np.setdiff1d(np.arange(p), noisy)
    assert counts[noisy].mean() > 2.0 * counts[quiet].mean()


def test_build_perm_unsampled_first():
    p = 256
    accum, m2 = _flat_moments(p, 4.0)
    hole = np.arange(32, 48)
    accum[hole, 3] = 0.0
    m2[hole, 3] = 0.0
    counts = np.bincount(_perm(accum, m2), minlength=p)
    sampled = np.setdiff1d(np.arange(p), hole)
    assert counts[hole].min() >= counts[sampled].max()
    assert counts[hole].mean() > 1.5 * counts[sampled].mean()


def test_build_perm_concentration_is_bounded():
    p = 4096
    accum, m2 = _flat_moments(p, 8.0)
    m2[7, :3] = 1e6
    counts = np.bincount(_perm(accum, m2), minlength=p)
    assert counts[7] < 0.97 * p
    assert (counts > 0).sum() > 0.02 * p


def test_perm_scheduler():
    s = tad.PermScheduler(4)
    phases = [s.tick(n) for n in (1, 2, 1, 4, 3, 9)]
    assert phases[:2] == [None, None] and phases[4] is None
    assert phases[2] == pytest.approx(0.6180339887)
    assert phases[3] == pytest.approx((2 * 0.6180339887) % 1.0)
    assert s.rebuilds == 3


def test_renderer_end_to_end_adaptive():
    r = tr.Renderer(_plane(), _cfg("on", adaptive_interval=4), device="cpu")
    for _ in range(4):
        r.step(_camera(), 4)
    assert r._sched.rebuilds >= 3
    perm = r.state.pixel_perm.numpy()
    assert (np.diff(perm) >= 0).all() and perm.max() < 32 * 32
    assert not np.array_equal(perm, np.arange(32 * 32))
    accum = r.state.accum.numpy()
    assert np.isfinite(accum).all() and (accum[:, 3] > 0).mean() > 0.9
    ru = tr.Renderer(_plane(), _cfg("off"), device="cpu")
    for _ in range(4):
        ru.step(_camera(), 4)
    assert abs(float(r.image().mean()) - float(ru.image().mean())) < 0.05
    # a new pose puts the visit order back to the identity
    cam = _camera()
    cam.horizontal_angle += 0.2
    r.step(cam, 0)
    np.testing.assert_array_equal(r.state.pixel_perm.numpy(),
                                  np.arange(32 * 32))
    assert float(r.state.moment2.abs().sum()) == 0.0


def test_stale_perm_fails_fast():
    r = tr.Renderer(_plane(), _cfg("on"), device="cpu")
    r.state = tr.init_state(_cfg("off"), "cpu")
    with pytest.raises(ValueError, match="pixel_perm"):
        r.step(_camera(), 1)


def test_track_variance_and_noise_estimate():
    cfg = small_config(width=16, height=16, num_rays=1 << 10,
                       track_variance="on")
    cam = Camera()
    cam.position = np.array([0.0, -170.0, 40.0], np.float32)
    cam.vertical_angle = -0.10
    r = tr.Renderer(Scene.load(None), cfg, device="cpu")
    r.step(cam, 8)
    n1 = r.noise_estimate()
    r.step(cam, 56)
    n2 = r.noise_estimate()
    assert np.isfinite(n1) and n1 > 0
    assert n2 < n1
    r0 = tr.Renderer(Scene.load(None), small_config(
        width=16, height=16, num_rays=1 << 10), device="cpu")
    r0.step(cam, 1)
    with pytest.raises(RuntimeError, match="track_variance"):
        r0.noise_estimate()
