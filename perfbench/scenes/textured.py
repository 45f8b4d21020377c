"""The textured scene: the frozen terrain of ``perfbench/terrain.py`` and
the configuration's sphere rows (:mod:`perfbench.scenes.terrain_spheres`)
under a frozen copy of the program's textured scene
(``tyrant_tpu_torch/scene/files.py``: ``textured_scene``,
``scene_textures`` and their helpers and constants), so that an edit to
the program's generator cannot move the yardstick.

The mesh gets planar uvs that repeat every ``UV_TILE`` units, an albedo
and a tangent-space normal map, and where its triangles' centroids have
x > ``METAL_X`` a GGX conductor under a roughness (channel 0) and
metalness (channel 1) map; above it float alpha-cutout leaf quads (a
clamped leaf map whose alpha is below 0.5 outside an ellipse) and upright
blend panes of constant alpha 0.5.  The configuration's ``scene.textured``
group gives the counts, the seed, the ground height and the map sizes.
``perfbench/tests/test_pb_textured.py`` holds the arrays equal to those of
the program's generator when this copy was taken.
"""

from __future__ import annotations

import numpy as np

from perfbench.scenes import terrain_spheres

DIFF, GGX = 0, 5  # the program's material ids
# world units a texture repeat of the mesh's planar uvs, the texture ids
# (atlas order) and their wrap modes (0 repeat, 1 clamp to edge, 2
# mirrored repeat), the mesh's metal region (triangle centroids with x
# above it) and the tints
UV_TILE = 25.0
TEX_ALBEDO, TEX_NORMAL, TEX_ROUGH_METAL, TEX_LEAF, TEX_BLEND = range(5)
TEXTURE_WRAPS = ((0, 0), (0, 0), (2, 2), (1, 1), (0, 0))
METAL_X = 20.0
LEAF_TINT = (0.55, 0.85, 0.45)
BLEND_TINT = (0.95, 0.55, 0.35)


def _noise(n: int, cells: int, rng) -> np.ndarray:
    """[n, n] float32 value noise in [0, 1]: a random (cells+1)^2 grid,
    bilinearly upsampled, that tiles with period n."""
    g = rng.random((cells + 1, cells + 1))
    g[-1], g[:, -1] = g[0], g[:, 0]
    t = np.arange(n) * (cells / n)
    i = t.astype(np.int64)
    f = t - i
    rows = g[i] * (1 - f)[:, None] + g[i + 1] * f[:, None]
    return (rows[:, i] * (1 - f) + rows[:, i + 1] * f).astype(np.float32)


def scene_textures(albedo_px: int = 2048, normal_px: int = 2048,
                   rough_px: int = 1024, leaf_px: int = 512,
                   seed: int = 11) -> list:
    """The five maps, in ``TEX_*`` order, from numpy with ``seed``: an RGBA
    albedo (alpha 1 everywhere), a tangent-space normal map from a height
    field, a roughness (channel 0) and metalness (channel 1) map, an RGBA
    leaf whose alpha is below 0.5 on about half of its texels (outside an
    ellipse), and a 4x4 RGBA of constant alpha 0.5 for the blend panes."""
    rng = np.random.default_rng(seed)
    a = albedo_px
    n1, n2 = _noise(a, 8, rng), _noise(a, 64, rng)
    yy, xx = np.mgrid[0:a, 0:a]
    bricks = ((yy // (a // 16) + xx // (a // 16)) % 2).astype(np.float32)
    albedo = np.ones((a, a, 4), np.float32)
    albedo[..., 0] = 0.35 + 0.4 * n1 + 0.15 * bricks
    albedo[..., 1] = 0.3 + 0.3 * n2 + 0.1 * bricks
    albedo[..., 2] = 0.2 + 0.25 * n1 * n2
    # the height field's gradient, wrapped so that the map tiles
    h = 0.6 * _noise(normal_px, 32, rng) + 0.4 * _noise(normal_px, 128, rng)
    scale = normal_px / 16.0
    dx = (np.roll(h, -1, 1) - np.roll(h, 1, 1)) * scale
    dy = (np.roll(h, 1, 0) - np.roll(h, -1, 0)) * scale  # row 0 is the top
    nrm = np.stack([-dx, -dy, np.ones_like(h)], -1)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    normal = (0.5 * nrm + 0.5).astype(np.float32)
    r = rough_px
    rm = np.zeros((r, r, 3), np.float32)
    rm[..., 0] = 0.08 + 0.7 * _noise(r, 16, rng)
    ry, rx = np.mgrid[0:r, 0:r]
    rm[..., 1] = np.where((ry // (r // 8) + rx // (r // 8)) % 3 == 0, 0.1,
                          0.9 + 0.1 * _noise(r, 4, rng))
    q = (np.arange(leaf_px) + 0.5) / leaf_px - 0.5
    ly, lx = np.meshgrid(q, q, indexing="ij")
    inside = (lx / 0.48) ** 2 + (ly / 0.33) ** 2 <= 1.0
    leaf = np.ones((leaf_px, leaf_px, 4), np.float32)
    leaf[..., 0] = 0.3 + 0.2 * np.abs(ly) / 0.5
    leaf[..., 1] = 0.6 + 0.3 * (1.0 - np.abs(lx) / 0.5)
    leaf[..., 2] = 0.2
    leaf[..., 3] = np.where(inside, 1.0, 0.2 * np.abs(lx) / 0.5)
    blend = np.full((4, 4, 4), 0.5, np.float32)
    blend[..., :3] = 1.0
    return [albedo, normal, rm, leaf, blend]


def _quads(centers, size, axis_u, axis_v):
    """Two triangles a quad [2Q, 3] each (v0, v1, v2) and their corner uvs
    [2Q, 3, 2], the quads centred on ``centers`` [Q, 3] and spanned by
    ``size`` times the unit axes [Q, 3]."""
    hu = 0.5 * size[:, None] * axis_u
    hv = 0.5 * size[:, None] * axis_v
    p00, p10 = centers - hu - hv, centers + hu - hv
    p11, p01 = centers + hu + hv, centers - hu + hv
    v0 = np.concatenate([p00, p00])
    v1 = np.concatenate([p10, p11])
    v2 = np.concatenate([p11, p01])
    q = centers.shape[0]
    uv = np.concatenate([np.tile([[0, 0], [1, 0], [1, 1]], (q, 1, 1)),
                         np.tile([[0, 0], [1, 1], [0, 1]], (q, 1, 1))])
    return (v0.astype(np.float32), v1.astype(np.float32),
            v2.astype(np.float32), uv.astype(np.float32))


def _unit(v):
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def textured_scene(v0, v1, v2, n_leaves: int = 65_536, n_blend: int = 1_024,
                   seed: int = 11, ground_z: float = -20.0,
                   **texture_px) -> dict:
    """The keyword arguments of ``Scene.from_triangles`` for the textured
    scene on the mesh (v0, v1, v2), without its spheres: ``n_leaves``
    leaf quads and ``n_blend`` / 2 blend panes placed from ``seed`` over
    the mesh's height (the highest triangle over each of 64 x 64 bins) or
    over ``ground_z`` where that is higher.  ``texture_px`` sizes the maps
    (:func:`scene_textures`)."""
    rng = np.random.default_rng(seed)
    v0, v1, v2 = (np.asarray(v, np.float32) for v in (v0, v1, v2))
    t = v0.shape[0]
    corners = np.stack([v0, v1, v2], 1)
    uv_mesh = corners[:, :, :2] / UV_TILE
    cx = corners[:, :, 0].mean(1)
    metal = cx > METAL_X

    lo, hi = corners.reshape(-1, 3).min(0), corners.reshape(-1, 3).max(0)
    bins = 64
    size = np.maximum(hi[:2] - lo[:2], 1e-6) / bins

    def cell(xy):
        return np.clip(((xy - lo[:2]) / size).astype(np.int64), 0, bins - 1)
    # the mesh's height: each triangle's top raised over the bins its
    # bounding box covers
    top = np.full((bins, bins), max(float(lo[2]), ground_z), np.float64)
    c0, c1 = cell(corners.min(1)[:, :2]), cell(corners.max(1)[:, :2])
    z_top = corners[:, :, 2].max(1)
    span = c1 - c0
    for dx in range(int(span[:, 0].max()) + 1):
        for dy in range(int(span[:, 1].max()) + 1):
            m = (span[:, 0] >= dx) & (span[:, 1] >= dy)
            np.maximum.at(top, (c0[m, 0] + dx, c0[m, 1] + dy), z_top[m])

    def above(n_q, lift_lo, lift_hi):
        xy = lo[:2] + rng.random((n_q, 2)) * (hi[:2] - lo[:2])
        c = cell(xy)
        z = top[c[:, 0], c[:, 1]] + rng.uniform(lift_lo, lift_hi, n_q)
        return np.concatenate([xy, z[:, None]], 1)

    nl = n_leaves
    leaf_c = above(nl, 2.0, 30.0)
    nrm = _unit(rng.normal(size=(nl, 3)) + [0.0, 0.0, 1.5])
    au = _unit(np.cross(nrm, _unit(rng.normal(size=(nl, 3)))))
    lv0, lv1, lv2, luv = _quads(leaf_c, rng.uniform(1.5, 4.0, nl), au,
                                np.cross(nrm, au))
    nb = n_blend // 2
    pane_c = above(nb, 3.0, 12.0)
    phi = rng.uniform(0.0, 2.0 * np.pi, nb)
    bu = np.stack([np.cos(phi), np.sin(phi), np.zeros(nb)], 1)
    bv0, bv1, bv2, buv = _quads(pane_c, rng.uniform(4.0, 9.0, nb), bu,
                                np.tile([0.0, 0.0, 1.0], (nb, 1)))

    n_leaf_t, n_blend_t = 2 * nl, 2 * nb

    def ids(mesh, leaf, pane):
        return np.concatenate([mesh, np.full(n_leaf_t, leaf, np.int32),
                               np.full(n_blend_t, pane, np.int32)])
    return dict(
        v0=np.concatenate([v0, lv0, bv0]), v1=np.concatenate([v1, lv1, bv1]),
        v2=np.concatenate([v2, lv2, bv2]),
        tri_uv=np.concatenate([uv_mesh, luv, buv]).astype(np.float32),
        tri_tex=ids(np.full(t, TEX_ALBEDO, np.int32), TEX_LEAF, TEX_BLEND),
        tri_ntex=ids(np.full(t, TEX_NORMAL, np.int32), -1, -1),
        tri_rtex=ids(np.where(metal, TEX_ROUGH_METAL, -1).astype(np.int32),
                     -1, -1),
        tri_refl=ids(np.where(metal, GGX, DIFF).astype(np.int32), DIFF,
                     DIFF),
        tri_metal=np.concatenate([metal, np.zeros(n_leaf_t + n_blend_t,
                                                  bool)]),
        tri_blend=np.concatenate([np.zeros(t + n_leaf_t, bool),
                                  np.ones(n_blend_t, bool)]),
        tri_color=np.concatenate([np.ones((t, 3)),
                                  np.tile(LEAF_TINT, (n_leaf_t, 1)),
                                  np.tile(BLEND_TINT, (n_blend_t, 1))]
                                 ).astype(np.float32),
        tri_rough=np.full(t + n_leaf_t + n_blend_t, 0.3, np.float32),
        textures=scene_textures(seed=seed, **texture_px),
        texture_wraps=[tuple(w) for w in TEXTURE_WRAPS])


def make(scene: dict) -> dict:
    """The terrain (``scene.terrain``) and sphere rows (``scene.spheres``)
    of :func:`terrain_spheres.make`, textured as ``scene.textured`` says
    (the keyword arguments of :func:`textured_scene`)."""
    kw = terrain_spheres.make(scene)
    return dict(textured_scene(kw["v0"], kw["v1"], kw["v2"],
                               **scene["textured"]),
                spheres=kw["spheres"])
