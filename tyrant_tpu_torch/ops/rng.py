"""Stateless xorshift RNG, the port of ``tyrant_tpu/ops/rng.py``.

Every stream is uint32 arithmetic.  PyTorch's uint32 dtype lacks shifts
and multiplies on several backends, so the values live in int64 tensors
and every operation that can leave [0, 2^32) is masked with 0xFFFFFFFF.
The streams are bitwise equal to the JAX package's.
"""

from __future__ import annotations

import torch

_MASK = 0xFFFFFFFF
_GOLDEN = 0x9E3779B9
# float32(2.3283064365387e-10), the reference's 1/2^32 scale (kernel.cu:31-33)
_INV_2_32 = 2.3283064365387e-10


def _u32(p):
    """A tensor as int64 in [0, 2^32); a Python int stays a Python int, so
    that nothing is copied from the host inside a step."""
    if isinstance(p, torch.Tensor):
        return p.to(torch.int64) & _MASK
    return int(p) & _MASK


def _fold(h, parts):
    """The hash state after ``parts``, from the state ``h``.  The hash runs
    on Python ints up to the first tensor component, on int64 tensors after
    it: the same exact integer arithmetic either way."""
    for p in parts:
        p = _u32(p)
        h = ((p + _GOLDEN + ((h << 6) & _MASK) + (h >> 2)) & _MASK) ^ h
        # wang hash round
        h = (h ^ 61) ^ (h >> 16)
        h = (h * 9) & _MASK
        h = h ^ (h >> 4)
        h = (h * 0x27D4EB2D) & _MASK
        h = h ^ (h >> 15)
    return h


def seed_prefix(*parts):
    """The hash state of :func:`seed_from` after its first ``parts``: a
    family of seeds that share them (``seed_from(*rest, prefix=...)``)
    hashes them once."""
    return _fold(_GOLDEN, parts)


def seed_from(*parts, prefix=_GOLDEN) -> torch.Tensor:
    """A well-mixed uint32 seed (as int64) from integer components, after
    the hash state ``prefix`` of :func:`seed_prefix` when given."""
    like = next((p for p in (prefix, *parts)
                 if isinstance(p, torch.Tensor)), None)
    h = _fold(prefix, parts)
    if not isinstance(h, torch.Tensor):
        h = torch.tensor(h, dtype=torch.int64,
                         device=None if like is None else like.device)
    # xorshift has a fixed point at 0; nudge.
    return torch.where(h == 0, torch.full_like(h, 0x1337C0DE), h)


def xorshift(seed: torch.Tensor) -> torch.Tensor:
    """One Marsaglia xorshift32 step."""
    seed = seed ^ ((seed << 13) & _MASK)
    seed = seed ^ (seed >> 17)
    seed = seed ^ ((seed << 5) & _MASK)
    return seed


def random_float(seed: torch.Tensor):
    """Uniform float32 in [0, 1)."""
    seed = xorshift(seed)
    return seed, seed.to(torch.float32) * _INV_2_32


def random_float2(seed: torch.Tensor):
    """Uniform float32 in [0, 1] with 16-bit granularity."""
    seed = xorshift(seed)
    return seed, (seed >> 16).to(torch.float32) / 65535.0


def random_int_between_0_and_max(seed: torch.Tensor, max_value: int):
    """Integer in [0, max_value] (the reference's +0.99999 trick)."""
    seed, f = random_float(seed)
    return seed, (f * (max_value + 0.99999)).to(torch.int32)


def random_2d_stratified(seed: torch.Tensor):
    """Stratified 2-D sample over a 4x4 grid with a random stratum."""
    seed, stratum = random_int_between_0_and_max(seed, 15)
    sx = (stratum % 4).to(torch.float32)
    sy = ((stratum // 4) % 4).to(torch.float32)
    seed, jx = random_float(seed)
    seed, jy = random_float(seed)
    u = sx * 0.25 + jx * 0.25
    v = sy * 0.25 + jy * 0.25
    return seed, torch.stack([u, v], dim=-1)
