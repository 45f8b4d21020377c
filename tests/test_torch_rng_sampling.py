"""RNG, sampling, intersection, sky and tone mapping of the PyTorch port
against the JAX package on the same numpy inputs.

RNG streams are integer arithmetic and must be bitwise equal.  Float
functions agree to rtol 1e-5 / atol 1e-6: transcendentals differ in the
last ulp between XLA and PyTorch."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tyrant_tpu import sky as jsky
from tyrant_tpu.config import SkyConfig
from tyrant_tpu.ops import intersect as jint
from tyrant_tpu.ops import rng as jrng
from tyrant_tpu.ops import sampling as jsamp
from tyrant_tpu.ops import tonemap as jtone
from tyrant_tpu_torch import sky as tsky
from tyrant_tpu_torch.ops import intersect as tint
from tyrant_tpu_torch.ops import rng as trng
from tyrant_tpu_torch.ops import sampling as tsamp
from tyrant_tpu_torch.ops import tonemap as ttone

RTOL, ATOL = 1e-5, 1e-6


def _seeds(n=4096, seed=0):
    r = np.random.default_rng(seed)
    return r.integers(0, 2 ** 32, size=n, dtype=np.uint64).astype(np.uint32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(a, b):
    np.testing.assert_allclose(_np(a), _np(b), rtol=RTOL, atol=ATOL)


def _unit(n, seed):
    v = np.random.default_rng(seed).normal(size=(n, 3)).astype(np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def test_seed_from_bitwise():
    r = np.random.default_rng(1)
    frame = np.uint32(r.integers(1, 2 ** 31))
    pix = r.integers(0, 2 ** 21, size=4096).astype(np.int32)
    slot = np.arange(4096, dtype=np.int32)
    want = np.asarray(jrng.seed_from(frame, jnp.asarray(pix),
                                     jnp.asarray(slot), 0, 0x5ADE))
    got = trng.seed_from(torch.tensor(int(frame)), _t(pix).long(),
                         _t(slot).long(), 0, 0x5ADE)
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)
    assert got.min() >= 0 and got.max() < 2 ** 32


def test_xorshift_and_random_float_bitwise():
    s = _seeds()
    js, ts = jnp.asarray(s), _t(s.astype(np.int64))
    np.testing.assert_array_equal(
        trng.xorshift(ts).numpy().astype(np.uint32),
        np.asarray(jrng.xorshift(js)))
    for _ in range(3):
        js, jf = jrng.random_float(js)
        ts, tf = trng.random_float(ts)
        np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
        np.testing.assert_array_equal(ts.numpy().astype(np.uint32),
                                      np.asarray(js))
    _, jf2 = jrng.random_float2(js)
    _, tf2 = trng.random_float2(ts)
    np.testing.assert_array_equal(tf2.numpy(), np.asarray(jf2))


def test_random_2d_stratified_bitwise():
    s = _seeds(seed=2)
    js, ju = jrng.random_2d_stratified(jnp.asarray(s))
    ts, tu = trng.random_2d_stratified(_t(s.astype(np.int64)))
    np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))
    np.testing.assert_array_equal(ts.numpy().astype(np.uint32), np.asarray(js))


def test_samplers_match():
    n = 2048
    s = _seeds(n, seed=3)
    nrm = _unit(n, 4)
    js, ts = jnp.asarray(s), _t(s.astype(np.int64))
    _, jd = jsamp.cosine_hemisphere_sample(jnp.asarray(nrm), js)
    _, td = tsamp.cosine_hemisphere_sample(_t(nrm), ts)
    _close(td, jd)
    _, jd = jsamp.phong_lobe_sample(jnp.asarray(nrm), 40.0, js)
    _, td = tsamp.phong_lobe_sample(_t(nrm), 40.0, ts)
    _close(td, jd)
    _, jd = jsamp.cone_sample(jnp.asarray(nrm), 3e-4, js)
    _, td = tsamp.cone_sample(_t(nrm), 3e-4, ts)
    _close(td, jd)
    c = np.asarray([0.0, -80.0, 120.0], np.float32)
    _, jp = jsamp.sphere_surface_sample(jnp.broadcast_to(jnp.asarray(c), (n, 3)),
                                        jnp.float32(9.0), js)
    _, tp = tsamp.sphere_surface_sample(_t(c).expand(n, 3),
                                        torch.tensor(9.0), ts)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=RTOL, atol=ATOL)
    u = np.random.default_rng(5).random((n, 2)).astype(np.float32)
    u[:4] = 0.5  # the degenerate disk centre
    _close(tsamp.concentric_sample_disk(_t(u)),
           jsamp.concentric_sample_disk(jnp.asarray(u)))
    _close(tsamp.reflect(_t(nrm), _t(_unit(n, 6))),
           jsamp.reflect(jnp.asarray(nrm), jnp.asarray(_unit(n, 6))))


def test_intersect_matches():
    r = np.random.default_rng(7)
    n = 2048
    o = r.uniform(-60, 60, (n, 3)).astype(np.float32)
    d = _unit(n, 8)
    v0 = r.uniform(-30, 30, (n, 3)).astype(np.float32)
    e1 = r.normal(0, 20, (n, 3)).astype(np.float32)
    e2 = r.normal(0, 20, (n, 3)).astype(np.float32)
    jt = np.asarray(jint.moller_trumbore(*map(jnp.asarray, (o, d, v0, e1, e2))))
    tt = tint.moller_trumbore(*map(_t, (o, d, v0, e1, e2))).numpy()
    np.testing.assert_array_equal(tt != 0, jt != 0)
    np.testing.assert_allclose(tt, jt, rtol=RTOL, atol=ATOL)
    from tyrant_tpu_torch.scene.scene import Spheres
    sp = Spheres.default_seven()
    jt, ji = jint.intersect_spheres(jnp.asarray(o), jnp.asarray(d),
                                    jnp.asarray(sp.center),
                                    jnp.asarray(sp.radius))
    tt, ti = tint.intersect_spheres(_t(o), _t(d), _t(sp.center),
                                    _t(sp.radius))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    # the ground sphere (radius 1e4) cancels b^2 - |op|^2 + r^2 at 1e8
    # magnitudes, so its roots carry ~1e-3 absolute error under any
    # summation order (XLA contracts into FMAs, eager PyTorch does not)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=RTOL,
                               atol=1e-3)


@pytest.mark.parametrize("sun_position", [(0.05, 0.3), (0.4, 0.45)])
def test_sky_matches(sun_position):
    params_j = jsky.SkyParams(SkyConfig())
    params_t = tsky.SkyParams(SkyConfig())
    jsun = jsky.sun_direction_from_position(jnp.asarray(sun_position))
    tsun = tsky.sun_direction_from_position(sun_position, "cpu")
    _close(tsun, jsun)
    v = _unit(2048, 9)
    v[:8] = np.asarray(jsun)  # inside the solar disc
    jv, jss = jsky.sky_and_sunsky(jnp.asarray(v), jsun, params_j)
    tv, tss = tsky.sky_and_sunsky(_t(v), tsun, params_t)
    _close(tv, jv)
    np.testing.assert_allclose(tss.numpy(), np.asarray(jss), rtol=RTOL,
                               atol=ATOL)
    _close(tsky.sun(_t(v), tsun, params_t), jsky.sun(jnp.asarray(v), jsun,
                                                     params_j))


@pytest.mark.parametrize("operator", ["reinhard", "aces"])
def test_tonemap_matches(operator):
    r = np.random.default_rng(10)
    acc = np.abs(r.normal(0, 3, (64 * 32, 4))).astype(np.float32)
    acc[:5, 3] = 0.0  # unvisited pixels
    ji = np.asarray(jtone.resolve(jnp.asarray(acc), 64, 32, operator, 1.5))
    ti = ttone.resolve(_t(acc), 64, 32, operator, 1.5).numpy()
    _close(ti, ji)
    np.testing.assert_array_equal(
        ttone.to_uint8(_t(ji)).numpy(), np.asarray(jtone.to_uint8(ji)))
