"""Environment-light importance sampling tables, a copy of
``tyrant_tpu/scene/envlight.py`` (host numpy, held bit for bit against
the original).

Per texel a probability proportional to luminance x sin(theta) (solid-
angle weighted), the matching solid-angle pdf (which ``Scene.to_device``
stores in env_data lane 3, so the miss path's MIS weight reads the same
nearest-texel pdf the sampler drew from) and Vose alias rows [N, 12]:
keep probability, alias index, and the (rgb, pdf) of both outcomes, so
one gathered row resolves coin -> texel -> radiance and pdf.  The same
alias builder makes the > 64-light power pick's rows (``light_alias``).
"""

from __future__ import annotations

import numpy as np

# BT.709 luminance weights: the one copy every power and importance
# weight derives from (env texel weights here, per-light powers in
# scene.py, the MIS hit-side pdf in render.py); the MIS weights sum to 1
# only when all sites use the same values
LUM_RGB = np.array([0.2126, 0.7152, 0.0722], np.float32)


def build_alias(p: np.ndarray):
    """Vose's O(N) alias method.  ``p`` sums to 1.  Returns (prob, alias):
    draw i ~ U{0..N-1}, u ~ U[0,1); the sample is i if u < prob[i] else
    alias[i]."""
    n = p.shape[0]
    prob = np.zeros(n, np.float64)
    alias = np.arange(n, dtype=np.int64)
    scaled = p.astype(np.float64) * n
    small = [i for i in range(n) if scaled[i] < 1.0]
    large = [i for i in range(n) if scaled[i] >= 1.0]
    while small and large:
        s = small.pop()
        g = large.pop()
        prob[s] = scaled[s]
        alias[s] = g
        scaled[g] = (scaled[g] + scaled[s]) - 1.0
        (small if scaled[g] < 1.0 else large).append(g)
    for i in large:
        prob[i] = 1.0
    for i in small:
        prob[i] = 1.0  # numerical leftovers
    return prob.astype(np.float32), alias


def env_tables(em: np.ndarray):
    """Build (pdf_sa [H*W] f32, alias_rows [H*W, 12] f32) for an
    equirectangular radiance map [H, W, 3] (z-up, v=0 at the zenith —
    the render._sample_envmap convention)."""
    eh, ew = em.shape[0], em.shape[1]
    n = eh * ew
    if n > (1 << 24):
        raise ValueError(
            f"envmap of {n} texels exceeds the f32-exact alias-index "
            "limit (2^24); downsample the environment map")
    rgb = np.asarray(em[:, :, :3], np.float64).reshape(n, 3)
    lum = rgb @ LUM_RGB.astype(np.float64)
    sin_t = np.sin((np.arange(eh) + 0.5) * np.pi / eh)
    w = (lum.reshape(eh, ew) * sin_t[:, None]).reshape(n)
    w = np.maximum(w, 0.0)
    tot = w.sum()
    if tot <= 0.0:
        w = np.repeat(sin_t, ew)  # black map: uniform over solid angle
        tot = w.sum()
    p = w / tot
    omega = (2.0 * np.pi / ew) * (np.pi / eh) * np.repeat(sin_t, ew)
    pdf_sa = np.where(p > 0, p / np.maximum(omega, 1e-12), 0.0)

    prob, alias = build_alias(p)
    rows = np.zeros((n, 12), np.float32)
    rows[:, 0] = prob
    rows[:, 1] = alias.astype(np.float32)  # exact below 2^24
    rows[:, 2:5] = rgb.astype(np.float32)
    rows[:, 5] = pdf_sa.astype(np.float32)
    rows[:, 6:9] = rgb[alias].astype(np.float32)
    rows[:, 9] = pdf_sa[alias].astype(np.float32)
    return pdf_sa.astype(np.float32), rows
