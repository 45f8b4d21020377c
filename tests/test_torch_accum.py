"""The port's plain accumulate_sorted against the JAX package's CPU scatter
(render.py's path on CPU: counts exact, rgb at rtol 1e-6) and the Pallas
accumulation kernel in interpret mode (counts exact, rgb at rtol 2^-8, the
kernel's bf16 rounding of update values).  Sentinel entries must be
ignored.  accumulate_terminated, the render step's call fed straight from
its sort, against the same scatter on the updates the step used to build,
on the run-head kernel's edge cases, and inside a render step bit for bit
against accumulate_sorted on those updates; its moment2 mode's plain
version (the squared radiance into a second buffer) against the JAX
step's CPU scatter of the second moments."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tyrant_tpu.ops.pallas import accum_kernel as jacc
from tyrant_tpu_torch import render as tr
from tyrant_tpu_torch.bench.poses import camera_for_pose
from tyrant_tpu_torch.config import small_config
from tyrant_tpu_torch.ops.kernels import accum as tacc
from tyrant_tpu_torch.scene.procgen import terrain
from tyrant_tpu_torch.scene.scene import Scene

from . import accum_cases


def _case(p, n, seed, frac_sentinel=0.3):
    rng = np.random.default_rng(seed)
    accum = rng.normal(size=(p, 4)).astype(np.float32)
    accum[:, 3] = rng.integers(0, 5, p)
    pix = rng.integers(0, p, size=n).astype(np.int32)
    # hot pixels at the JAX kernel's tile edges
    pix[: n // 8] = rng.choice([0, jacc.TILE_PIX - 1, jacc.TILE_PIX, p - 1],
                               n // 8)
    pix = np.where(rng.random(n) < frac_sentinel, tacc.sentinel(p), pix)
    pix = np.sort(pix).astype(np.int32)
    vals = rng.normal(size=(n, 4)).astype(np.float32)
    vals[:, 3] = 1.0  # path counts
    return accum, pix, vals


def test_sentinel_matches_jax():
    for p in (1, 2048, 2049, 1920 * 1080):
        assert tacc.sentinel(p) == jacc.sentinel(p)


@pytest.mark.parametrize("p,n", [(4 * 2048, 4 * 1024), (3000, 2048)])
def test_matches_jax_cpu_scatter(p, n):
    accum, pix, vals = _case(p, n, seed=p)
    sent = tacc.sentinel(p)
    term = pix < sent
    # render.py's CPU path: survivors add zeros to pixel 0
    upd = np.where(term[:, None], vals, 0.0).astype(np.float32)
    want = np.asarray(jnp.asarray(accum).at[np.where(term, pix, 0)]
                      .add(jnp.asarray(upd)))
    got = tacc.accumulate_sorted(torch.from_numpy(accum.copy()),
                                 torch.from_numpy(pix),
                                 torch.from_numpy(upd)).numpy()
    np.testing.assert_array_equal(got[:, 3], want[:, 3])
    np.testing.assert_allclose(got[:, :3], want[:, :3], rtol=1e-6, atol=1e-6)
    assert tacc.launches == 0  # CPU tensors never reach the kernel


def test_matches_pallas_kernel_interpret():
    p, n = 3 * 2048, 2 * 1024
    accum, pix, vals = _case(p, n, seed=5)
    want = np.asarray(jacc.accumulate_sorted(jnp.asarray(accum),
                                             jnp.asarray(pix),
                                             jnp.asarray(vals),
                                             interpret=True))
    acc_t = torch.from_numpy(accum.copy())
    got = tacc.accumulate_sorted(acc_t, torch.from_numpy(pix),
                                 torch.from_numpy(vals))
    assert got is acc_t  # in place
    got = got.numpy()
    np.testing.assert_array_equal(got[:, 3], want[:, 3])
    # bf16 rounds each update value by at most 2^-8 relative, so a pixel
    # may differ by 2^-8 of the summed magnitude of its updates
    live = pix < p
    mag = np.zeros((p, 3), np.float64)
    np.add.at(mag, pix[live], np.abs(vals[live, :3]))
    assert (np.abs(got[:, :3] - want[:, :3]) <= 2 ** -8 * mag + 1e-6).all()


def test_sentinel_entries_ignored():
    p = 100
    accum = np.zeros((p, 4), np.float32)
    pix = np.full(16, tacc.sentinel(p), np.int32)
    vals = np.ones((16, 4), np.float32)
    got = tacc.accumulate_sorted(torch.from_numpy(accum),
                                 torch.from_numpy(pix),
                                 torch.from_numpy(vals))
    assert not got.any()


def test_rejects_bad_inputs():
    accum = torch.zeros((8, 4))
    with pytest.raises(ValueError, match="int32"):
        tacc.accumulate_sorted(accum, torch.zeros(4, dtype=torch.int64),
                               torch.zeros((4, 4)))
    with pytest.raises(ValueError, match="shape"):
        tacc.accumulate_sorted(accum, torch.zeros(4, dtype=torch.int32),
                               torch.zeros((4, 3)))



def _step_updates(key, pend, sent):
    """The updates render_step built before it fed the kernel from its
    sort: the key clamped to the sentinel, (pend, 1) below it, zeros past
    it."""
    term = key < sent
    upd_pix = torch.clamp(key, max=sent).contiguous()
    upd_vals = torch.where(
        term[:, None], torch.cat([pend, torch.ones_like(pend[:, :1])], dim=1),
        torch.zeros((key.shape[0], 4), dtype=torch.float32))
    return upd_pix, upd_vals.contiguous()


@pytest.mark.parametrize("name", list(accum_cases.CASES))
def test_terminated_matches_jax_scatter(name):
    accum, key, pend = accum_cases.make_case(name, seed=3)
    p = accum.shape[0]
    upd_pix, upd_vals = (x.numpy() for x in _step_updates(
        torch.from_numpy(key), torch.from_numpy(pend), tacc.sentinel(p)))
    live = upd_pix < p  # the JAX CPU path's scatter, the rest added nowhere
    want = np.asarray(jnp.asarray(accum).at[np.where(live, upd_pix, 0)]
                      .add(jnp.asarray(np.where(live[:, None], upd_vals,
                                                0.0))))
    got = tacc.accumulate_terminated(torch.from_numpy(accum.copy()),
                                     torch.from_numpy(key),
                                     torch.from_numpy(pend)).numpy()
    np.testing.assert_array_equal(got[:, 3], want[:, 3])
    np.testing.assert_allclose(got[:, :3], want[:, :3], rtol=1e-6, atol=1e-6)
    if name == "all sentinel":
        np.testing.assert_array_equal(got, accum)
    assert tacc.launches == 0  # CPU tensors never reach the kernel


def test_terminated_is_sorted_on_the_step_updates():
    p, n = accum_cases.CASES["mixed"]
    accum, key, pend = (torch.from_numpy(x) for x in
                        accum_cases.make_case("mixed", seed=4))
    want = tacc.accumulate_sorted(accum.clone(), *tacc.terminated_updates(
        key, pend, p))
    got = tacc.accumulate_terminated(accum.clone(), key, pend)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    with pytest.raises(ValueError, match="pend"):
        tacc.accumulate_terminated(accum, key, torch.zeros((n, 4)))
    with pytest.raises(ValueError, match="key"):
        tacc.accumulate_terminated(accum, key.long(), pend)


def test_render_step_accumulates_as_before(monkeypatch):
    """On a seeded small scene on the CPU, the accumulation render_step
    makes through accumulate_terminated equals, bit for bit,
    accumulate_sorted on the updates the step used to build."""
    cfg = small_config(width=32, height=24, num_rays=2048)
    ren = tr.Renderer(Scene.from_triangles(*terrain(n_quads=12, towers=2)),
                      cfg, device="cpu")
    seen = []

    def spy(accum, key, pend):
        before = accum.clone()
        out = tacc.accumulate_terminated(accum, key, pend)
        want = tacc.accumulate_sorted(before, *_step_updates(
            key, pend, tacc.sentinel(cfg.num_pixels)))
        seen.append((int((key < cfg.num_pixels).sum()),
                     torch.equal(out.view(torch.int32),
                                 want.view(torch.int32))))
        return out

    monkeypatch.setattr(tr, "accumulate_terminated", spy)
    ren.step(camera_for_pose(0), 4)
    assert len(seen) == 4 and all(same for _, same in seen)
    assert all(live > 0 for live, _ in seen)
    assert float(ren.state.accum[:, 3].sum()) == sum(live for live, _ in seen)


@pytest.mark.parametrize("name", list(accum_cases.CASES))
def test_moment2_mode_matches_jax_scatter(name):
    """The second-moment mode's plain version (two accumulate_plain calls
    on the step's sorted keys) against the JAX step's CPU path: the
    scatters of (p, 1) into accum and (p * p, 1) into moment2
    (tyrant_tpu/render.py:2392-2406).  Counts exact and the two buffers'
    counts equal, sums within rtol 1e-6 (XLA's scatter adds in its own
    order); accumulate_terminated's accum bit for bit as without
    moment2."""
    accum, key, pend = accum_cases.make_case(name, seed=5)
    moment2 = np.abs(accum_cases.make_case(name, seed=6)[0])
    p = accum.shape[0]
    sent = tacc.sentinel(p)
    live = key < p
    idx = np.where(live, np.minimum(key, sent), 0)
    ones = np.ones((key.shape[0], 1), np.float32)
    ps = jnp.asarray(pend)
    want_a = np.asarray(jnp.asarray(accum).at[idx].add(jnp.where(
        live[:, None], jnp.concatenate([ps, ones], 1), 0.0)))
    want_m = np.asarray(jnp.asarray(moment2).at[idx].add(jnp.where(
        live[:, None], jnp.concatenate([ps * ps, ones], 1), 0.0)))
    m2 = torch.from_numpy(moment2.copy())
    got = tacc.accumulate_terminated(torch.from_numpy(accum.copy()),
                                     torch.from_numpy(key),
                                     torch.from_numpy(pend), moment2=m2)
    alone = tacc.accumulate_terminated(torch.from_numpy(accum.copy()),
                                       torch.from_numpy(key),
                                       torch.from_numpy(pend))
    assert torch.equal(got.view(torch.int32), alone.view(torch.int32))
    np.testing.assert_array_equal(got.numpy()[:, 3], want_a[:, 3])
    np.testing.assert_array_equal(m2.numpy()[:, 3] - moment2[:, 3],
                                  got.numpy()[:, 3] - accum[:, 3])
    np.testing.assert_array_equal(m2.numpy()[:, 3], want_m[:, 3])
    np.testing.assert_allclose(got.numpy()[:, :3], want_a[:, :3], rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(m2.numpy()[:, :3], want_m[:, :3], rtol=1e-6,
                               atol=1e-6)
    if name == "all sentinel":
        np.testing.assert_array_equal(m2.numpy(), moment2)
    # the plain version: accumulate_sorted on the squared updates
    m2b = tacc.accumulate_sorted(torch.from_numpy(moment2.copy()),
                                 *tacc.moment2_updates(
                                     torch.from_numpy(key),
                                     torch.from_numpy(pend), p))
    assert torch.equal(m2.view(torch.int32), m2b.view(torch.int32))
    assert tacc.launches == 0 and tacc.launches_moment2 == 0


def test_moment2_mode_checks_its_buffer():
    accum, key, pend = (torch.from_numpy(x) for x in
                        accum_cases.make_case("mixed", seed=4))
    p = accum.shape[0]
    with pytest.raises(ValueError, match="moment2"):
        tacc.accumulate_terminated(accum, key, pend,
                                   moment2=torch.zeros((p - 1, 4)))
    with pytest.raises(ValueError, match="moment2"):
        tacc.accumulate_terminated(accum, key, pend,
                                   moment2=torch.zeros((p, 4),
                                                       dtype=torch.float64))
