"""The port's plain accumulate_sorted against the JAX package's CPU scatter
(render.py's path on CPU: counts exact, rgb at rtol 1e-6) and the Pallas
accumulation kernel in interpret mode (counts exact, rgb at rtol 2^-8, the
kernel's bf16 rounding of update values).  Sentinel entries must be
ignored."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tyrant_tpu.ops.pallas import accum_kernel as jacc
from tyrant_tpu_torch.ops.kernels import accum as tacc


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

