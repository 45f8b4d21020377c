"""Shuffled, Owen-scrambled 2-D Sobol sampling, the port of
``tyrant_tpu/ops/sobol.py`` (``RenderConfig.sampler == "sobol"``).

Every draw is a point of the 2-D Sobol sequence (dimension 0 the van der
Corput bit reversal, dimension 1 the x + 1 primitive-polynomial
recurrence), made unique per (pixel, purpose) key by a nested-uniform
shuffle of the sample index and a nested-uniform (Owen) scramble of each
axis: the Laine-Karras hash permutation on reversed bits (Burley,
"Practical Hash-based Owen Scrambling", JCGT 2020).

The values are uint32 held in int64 tensors, as in ``ops/rng.py``.  A
product of a u32 with a constant above 2^31 can pass 2^63, so such a
multiply is split by the constant's 16-bit halves (:func:`_mul32`): no
intermediate leaves int64's range and nothing relies on signed
wraparound.  The draws are bit-equal to the JAX package's.

Two rewrites take ops out of the per-draw chain without changing a bit
(tests/test_torch_sobol.py holds every function against the JAX one):
:func:`sobol_dim1` folds the 32 direction numbers in five shift-xor steps
(the x + 1 direction matrix is Pascal's triangle mod 2, whose product with
a bit vector is the superset Möbius transform over the bit positions,
then a bit reversal), and :func:`sample_2d`/:func:`sample_1d` drop the two
bit reversals that cancel between a dimension and its scramble.
"""

from __future__ import annotations

import torch

from .rng import _MASK

_HALF = 0xFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for x in [0, 2^32) as int64: one product for
    c < 2^31 (below 2^63), else by c's 16-bit halves (each below 2^48)."""
    if c < (1 << 31):
        return (x * c) & _MASK
    hi = ((x * (c >> 16)) & _HALF) << 16
    return (hi + x * (c & _HALF)) & _MASK


def reverse_bits32(x: torch.Tensor) -> torch.Tensor:
    x = ((x >> 1) & 0x55555555) | ((x & 0x55555555) << 1)
    x = ((x >> 2) & 0x33333333) | ((x & 0x33333333) << 2)
    x = ((x >> 4) & 0x0F0F0F0F) | ((x & 0x0F0F0F0F) << 4)
    x = ((x >> 8) & 0x00FF00FF) | ((x & 0x00FF00FF) << 8)
    return (x >> 16) | ((x << 16) & _MASK)


def laine_karras(x: torch.Tensor, seed) -> torch.Tensor:
    """Hash permutation of the unit interval's high bits (inputs that
    agree in their top k bits give outputs that do too)."""
    x = (x + seed) & _MASK
    x = x ^ _mul32(x, 0x6C50B47C)
    x = x ^ _mul32(x, 0xB82F1E52)
    x = x ^ _mul32(x, 0xC7AFE638)
    x = x ^ _mul32(x, 0x8D22F6E6)
    return x


def nested_uniform_scramble(x: torch.Tensor, seed) -> torch.Tensor:
    """Owen scramble of a [0, 1) value encoded in u32 (low bits finest)."""
    return reverse_bits32(laine_karras(reverse_bits32(x), seed))


# dimension-1 direction numbers: v_0 = 1<<31, v_{j+1} = v_j ^ (v_j >> 1)
_V1 = []
_v = 1 << 31
for _ in range(32):
    _V1.append(_v)
    _v ^= _v >> 1
del _v

# the superset transform's steps: (stride, positions whose bit of that
# stride is clear)
_SUPERSET = ((1, 0x55555555), (2, 0x33333333), (4, 0x0F0F0F0F),
             (8, 0x00FF00FF), (16, 0x0000FFFF))


def sobol_dim0(index: torch.Tensor) -> torch.Tensor:
    """The first dimension: the base-2 radical inverse."""
    return reverse_bits32(index)


def _superset(index: torch.Tensor) -> torch.Tensor:
    """Bit p of the result is the xor of the index bits j with p a subset
    of j (as 5-bit position numbers): by Lucas, bit 31 - p of the
    xor-fold of the ``_V1[j]`` the index selects."""
    for s, m in _SUPERSET:
        index = index ^ ((index >> s) & m)
    return index


def sobol_dim1(index: torch.Tensor) -> torch.Tensor:
    """The second dimension: the xor of the direction numbers selected by
    the index bits, as five shift-xor steps and a reversal."""
    return reverse_bits32(_superset(index))


def _to_unit_float(u: torch.Tensor) -> torch.Tensor:
    """Top 24 bits -> float32 in [0, 1)."""
    return (u >> 8).to(torch.float32) * (1.0 / (1 << 24))


def _key_mix(key: torch.Tensor, salt: int) -> torch.Tensor:
    """An independent stream seed from a draw key (finalizer-style mix)."""
    h = key ^ salt
    h = h ^ (h >> 16)
    h = _mul32(h, 0x7FEB352D)
    h = h ^ (h >> 15)
    h = _mul32(h, 0x846CA68B)
    return h ^ (h >> 16)


def _shuffled_index(sample_index: torch.Tensor, key: torch.Tensor):
    """The shuffled index, reversed: the scramble's outer reversal and
    dimension 0's cancel."""
    return laine_karras(reverse_bits32(sample_index & _MASK),
                        _key_mix(key, 0xA511E9B3))


def sample_2d(sample_index: torch.Tensor, key: torch.Tensor):
    """Point ``sample_index`` of the (pixel, purpose)-keyed shuffled,
    scrambled 2-D Sobol sequence: (u, v) float32 in [0, 1)."""
    idx_r = _shuffled_index(sample_index, key)  # reverse_bits32(idx)
    idx = reverse_bits32(idx_r)
    # scramble(dim0(idx)) = reverse(laine_karras(idx)); scramble(dim1(idx))
    # = reverse(laine_karras(_superset(idx)))
    u = reverse_bits32(laine_karras(idx, _key_mix(key, 0x1D8E4464)))
    v = reverse_bits32(laine_karras(_superset(idx),
                                    _key_mix(key, 0x8C7F1A2B)))
    return _to_unit_float(u), _to_unit_float(v)


def sample_1d(sample_index: torch.Tensor, key: torch.Tensor) -> torch.Tensor:
    """The van der Corput dimension alone."""
    idx = reverse_bits32(_shuffled_index(sample_index, key))
    return _to_unit_float(reverse_bits32(
        laine_karras(idx, _key_mix(key, 0x1D8E4464))))
