"""The benchmark's scene data: a frozen copy of the procedural terrain of
``tyrant_tpu_torch/scene/procgen.py`` (``terrain``, ``benchmark_scene``),
so that an edit to the program's generator cannot move the yardstick.

``perfbench/tests/test_pb_copies.py`` holds the arrays equal to those the
program's generator gave when this copy was taken.
"""

from __future__ import annotations

import numpy as np


def _value_noise(n, octaves, rng):
    h = np.zeros((n, n), np.float32)
    for o in range(octaves):
        k = 2 ** o + 1
        g = rng.normal(size=(k, k)).astype(np.float32)
        # bilinear upsample to n x n
        xi = np.linspace(0, k - 1, n)
        x0 = np.clip(xi.astype(int), 0, k - 2)
        fx = (xi - x0).astype(np.float32)
        gx = g[:, x0] * (1 - fx) + g[:, x0 + 1] * fx
        gy = gx[x0, :] * (1 - fx)[:, None] + gx[x0 + 1, :] * fx[:, None]
        h += gy / (1.6 ** o)
    return h


def _box(cx, cy, z0, w, h):
    """12 triangles, outward winding."""
    x0, x1 = cx - w, cx + w
    y0, y1 = cy - w, cy + w
    z1 = z0 + h
    p = np.array([[x0, y0, z0], [x1, y0, z0], [x1, y1, z0], [x0, y1, z0],
                  [x0, y0, z1], [x1, y0, z1], [x1, y1, z1], [x0, y1, z1]],
                 np.float32)
    quads = [(0, 1, 5, 4), (1, 2, 6, 5), (2, 3, 7, 6),
             (3, 0, 4, 7), (4, 5, 6, 7), (3, 2, 1, 0)]
    t = []
    for (i, j, k, l) in quads:
        t.append([p[i], p[j], p[k]])
        t.append([p[i], p[k], p[l]])
    return np.asarray(t, np.float32)


def terrain(n_quads: int = 256, extent: float = 200.0, height: float = 35.0,
            octaves: int = 6, seed: int = 7, z_offset: float = -20.0,
            towers: int = 12):
    """(v0, v1, v2) [T, 3] float32 with T = 2 * n_quads^2 + 12 * towers: a
    displaced grid whose triangles face +z, and axis-aligned boxes rising
    from it."""
    rng = np.random.default_rng(seed)
    n = n_quads + 1
    xs = np.linspace(-extent, extent, n).astype(np.float32)
    x, y = np.meshgrid(xs, xs, indexing="ij")
    z = _value_noise(n, octaves, rng) * height + z_offset
    v = np.stack([x, y, z], axis=-1)  # [n, n, 3]

    a = v[:-1, :-1].reshape(-1, 3)
    b = v[1:, :-1].reshape(-1, 3)
    c = v[:-1, 1:].reshape(-1, 3)
    d = v[1:, 1:].reshape(-1, 3)
    # two tris per quad: (a, b, c) and (b, d, c) make e1 x e2 point +z
    v0 = np.concatenate([a, b])
    v1 = np.concatenate([b, d])
    v2 = np.concatenate([c, c])

    tris = [np.stack([v0, v1, v2], axis=1)]
    for _ in range(towers):
        cx, cy = rng.uniform(-0.7 * extent, 0.7 * extent, 2)
        w = rng.uniform(4, 14)
        hgt = rng.uniform(15, 60)
        zb = float(z[np.searchsorted(xs, cx), np.searchsorted(xs, cy)]) - 2
        tris.append(_box(cx, cy, zb, w, hgt))
    allt = np.concatenate(tris).astype(np.float32)
    return allt[:, 0], allt[:, 1], allt[:, 2]


def benchmark_scene(n_tris_target: int = 1_000_000, seed: int = 7):
    """The terrain sized to about ``n_tris_target`` triangles."""
    n_quads = max(8, int(np.sqrt(n_tris_target / 2)))
    return terrain(n_quads=n_quads, seed=seed)
