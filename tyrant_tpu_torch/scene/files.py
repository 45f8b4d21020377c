"""Scene files written from arrays: a binary PLY mesh (with smooth vertex
normals if asked), a small OBJ/MTL asset, a JSON description that places
a mesh and instances of the asset, a sphere-free glTF binary, a
procedural HDR sky as an equirectangular PFM, and a JSON description of
a lit scene (emissive spheres, point/spot/directional lights, the
envmap) with the LIGHT triangles of its mesh (``lamp_triangles``); and,
in memory, the textured scene (``textured_scene``: a mesh with planar
repeating uvs under albedo, normal and roughness/metal maps, alpha-cutout
leaves and blend panes, every map made from numpy with a seed).

``chip_smoke.py`` and the CPU tests build the loaded-scene, lights and
textures paths from these, so they need no download; the loaders read
the files back as they read any other file.
"""

from __future__ import annotations

import json
import struct
from pathlib import Path

import numpy as np


def weld(v0, v1, v2):
    """(vertices [V, 3], faces [T, 3]) of a triangle soup, exact-equal
    corners merged."""
    corners = np.stack([v0, v1, v2], axis=1).reshape(-1, 3)
    verts, inv = np.unique(corners, axis=0, return_inverse=True)
    return verts.astype(np.float32), inv.reshape(-1, 3).astype(np.int32)


def vertex_normals(verts, faces):
    """Area-weighted vertex normals [V, 3] (unit; a vertex of degenerate
    triangles only gets (0, 0, 1))."""
    p = verts.astype(np.float64)
    n = np.cross(p[faces[:, 1]] - p[faces[:, 0]], p[faces[:, 2]] - p[faces[:, 0]])
    acc = np.zeros_like(p)
    for k in range(3):
        np.add.at(acc, faces[:, k], n)
    ln = np.linalg.norm(acc, axis=1, keepdims=True)
    out = np.where(ln > 0, acc / np.maximum(ln, 1e-300), [0.0, 0.0, 1.0])
    return out.astype(np.float32)


def write_ply(path, v0, v1, v2, normals: bool = False) -> dict:
    """Binary little-endian PLY of the welded soup; ``normals`` adds
    nx/ny/nz vertex properties.  Returns {"vertices", "faces"} counts."""
    verts, faces = weld(np.asarray(v0), np.asarray(v1), np.asarray(v2))
    props = ["x", "y", "z"] + (["nx", "ny", "nz"] if normals else [])
    head = ["ply", "format binary_little_endian 1.0",
            f"element vertex {verts.shape[0]}"]
    head += [f"property float {p}" for p in props]
    head += [f"element face {faces.shape[0]}",
             "property list uchar int vertex_indices", "end_header"]
    vrow = np.zeros(verts.shape[0], [(p, "<f4") for p in props])
    for i, p in enumerate("xyz"):
        vrow[p] = verts[:, i]
    if normals:
        vn = vertex_normals(verts, faces)
        for i, p in enumerate(("nx", "ny", "nz")):
            vrow[p] = vn[:, i]
    frow = np.zeros(faces.shape[0], [("n", "u1"), ("i", "<i4", (3,))])
    frow["n"] = 3
    frow["i"] = faces
    with open(path, "wb") as f:
        f.write(("\n".join(head) + "\n").encode())
        f.write(vrow.tobytes())
        f.write(frow.tobytes())
    return {"vertices": int(verts.shape[0]), "faces": int(faces.shape[0])}


def _uv_sphere(n_phi: int, n_theta: int, radius: float):
    """(vertices, normals, triangles as vertex-index triples, upper-half
    flag per triangle) of a UV sphere."""
    th = np.linspace(0.0, np.pi, n_theta + 1)
    ph = np.linspace(0.0, 2.0 * np.pi, n_phi, endpoint=False)
    tt, pp = np.meshgrid(th, ph, indexing="ij")
    n = np.stack([np.sin(tt) * np.cos(pp), np.sin(tt) * np.sin(pp),
                  np.cos(tt)], -1).reshape(-1, 3)
    tris, upper = [], []
    for i in range(n_theta):
        for j in range(n_phi):
            a = i * n_phi + j
            b = i * n_phi + (j + 1) % n_phi
            c, d = a + n_phi, b + n_phi
            if i > 0:
                tris.append((a, c, b))
                upper.append(i < n_theta // 2)
            if i < n_theta - 1:
                tris.append((b, c, d))
                upper.append(i < n_theta // 2)
    return (n * radius).astype(np.float32), n.astype(np.float32), tris, upper


def write_asset_obj(dirpath, n_phi: int = 24, n_theta: int = 12) -> str:
    """``asset.obj`` and ``asset.mtl`` in ``dirpath``: a UV sphere of
    radius 6 with corner normals (``vn``) and two MTL groups, the upper
    half a GGX conductor (``Pm 1``, ``Pr 0.3``), the lower half matte.
    Returns the .obj path."""
    d = Path(dirpath)
    (d / "asset.mtl").write_text(
        "newmtl gold\nKd 1.0 0.77 0.34\nPm 1.0\nPr 0.3\n"
        "newmtl matte\nKd 0.8 0.3 0.2\n")
    v, vn, tris, upper = _uv_sphere(n_phi, n_theta, 6.0)
    lines = ["mtllib asset.mtl"]
    lines += [f"v {x:.7g} {y:.7g} {z:.7g}" for x, y, z in v]
    lines += [f"vn {x:.7g} {y:.7g} {z:.7g}" for x, y, z in vn]
    for group in (True, False):
        lines.append("usemtl " + ("gold" if group else "matte"))
        lines += [f"f {a + 1}//{a + 1} {b + 1}//{b + 1} {c + 1}//{c + 1}"
                  for (a, b, c), up in zip(tris, upper) if up == group]
    path = d / "asset.obj"
    path.write_text("\n".join(lines) + "\n")
    return str(path)


def write_description(path, mesh: str, asset: str, placements,
                      dispersion: float = 0.0) -> str:
    """A JSON description: ``mesh`` once at the identity, and the asset
    at each (x, y, z) of ``placements`` in turn as its own GGX/matte
    materials, as glass of IOR 1.7 and as frosted glass (roughness 0.35),
    under the default seven spheres; ``dispersion`` goes to the render
    section.  Paths are written relative to the description's folder
    when they lie in it."""
    base = Path(path).resolve().parent

    def rel(p):
        p = Path(p).resolve()
        return str(p.relative_to(base)) if p.parent == base else str(p)
    looks = ("metal", "glass", "frosted")
    desc = {
        "meshes": [
            {"name": "mesh", "path": rel(mesh)},
            {"name": "metal", "path": rel(asset)},
            {"name": "glass", "path": rel(asset), "material": "glass",
             "color": [0.02, 0.01, 0.005], "ior": 1.7},
            {"name": "frosted", "path": rel(asset), "material": "frosted",
             "color": [0.01, 0.02, 0.02], "roughness": 0.35},
        ],
        "instances": [{"mesh": "mesh"}] + [
            {"mesh": looks[i % 3], "translate": [float(c) for c in xyz],
             "rotate_z": 30.0 * i}
            for i, xyz in enumerate(placements)],
        "default_spheres": True,
        "render": {"dispersion": dispersion} if dispersion else {},
    }
    Path(path).write_text(json.dumps(desc, indent=1))
    return str(path)


def write_glb(path, v0, v1, v2) -> str:
    """A glTF binary of one welded mesh (positions and indices, +Z up
    written as glTF's +Y up so the loader's axis swap restores it), one
    double-sided grey diffuse material, no lights, no camera."""
    verts, faces = weld(np.asarray(v0), np.asarray(v1), np.asarray(v2))
    yup = np.stack([verts[:, 0], verts[:, 2], -verts[:, 1]], 1)
    pos = yup.astype("<f4").tobytes()
    idx = faces.astype("<u4").tobytes()
    blob = pos + idx
    gltf = {
        "asset": {"version": "2.0"},
        "scene": 0, "scenes": [{"nodes": [0]}], "nodes": [{"mesh": 0}],
        "buffers": [{"byteLength": len(blob)}],
        "bufferViews": [
            {"buffer": 0, "byteOffset": 0, "byteLength": len(pos)},
            {"buffer": 0, "byteOffset": len(pos), "byteLength": len(idx)}],
        "accessors": [
            {"bufferView": 0, "componentType": 5126,
             "count": int(verts.shape[0]), "type": "VEC3",
             "min": yup.min(0).tolist(), "max": yup.max(0).tolist()},
            {"bufferView": 1, "componentType": 5125,
             "count": int(faces.size), "type": "SCALAR"}],
        "materials": [{"doubleSided": True,
                       "pbrMetallicRoughness": {
                           "baseColorFactor": [0.7, 0.7, 0.7, 1.0],
                           "metallicFactor": 0.0}}],
        "meshes": [{"primitives": [{"attributes": {"POSITION": 0},
                                    "indices": 1, "material": 0}]}],
    }
    js = json.dumps(gltf).encode()
    js += b" " * ((-len(js)) % 4)
    blob += b"\0" * ((-len(blob)) % 4)
    total = 12 + 8 + len(js) + 8 + len(blob)
    with open(path, "wb") as f:
        f.write(b"glTF" + struct.pack("<II", 2, total)
                + struct.pack("<I", len(js)) + b"JSON" + js
                + struct.pack("<I", len(blob)) + b"BIN\0" + blob)
    return str(path)


# the procedural sky's one bright patch: where it sits as (u, v), its
# side in texels and its radiance
SKY_SUN_UV = (0.3, 0.35)
SKY_SUN_TEXELS = 2
SKY_SUN_RADIANCE = (400.0, 360.0, 300.0)


def sky_envmap(height: int, width: int):
    """A procedural HDR equirect map [height, width, 3] float32 (z up, row
    0 at the zenith, as the renderer reads it): a sky gradient from deep
    blue at the zenith to a pale horizon, a dark ground below, and one
    small bright patch (``SKY_SUN_*``)."""
    v = (np.arange(height, dtype=np.float64) + 0.5) / height
    up = np.clip(1.0 - 2.0 * v, 0.0, 1.0)[:, None]   # 1 at the zenith
    zenith = np.array([0.15, 0.3, 0.9])
    horizon = np.array([0.9, 0.85, 0.8])
    sky = horizon + (zenith - horizon) * up ** 0.5
    ground = np.array([0.08, 0.07, 0.06])
    row = np.where((v < 0.5)[:, None], sky, ground)
    em = np.repeat(row[:, None, :], width, axis=1)
    y0 = int(SKY_SUN_UV[1] * height)
    x0 = int(SKY_SUN_UV[0] * width)
    em[y0:y0 + SKY_SUN_TEXELS, x0:x0 + SKY_SUN_TEXELS] = SKY_SUN_RADIANCE
    return em.astype(np.float32)


def write_envmap_pfm(path, height: int, width: int) -> str:
    """:func:`sky_envmap` written as a PFM file; returns the path."""
    from ..utils.pfm import write_pfm
    write_pfm(str(path), sky_envmap(height, width))
    return str(path)


# the lights path's three delta lights: a warm point lamp, a spot and a
# dim directional fill, placed over the benchmark terrain in pose 0's view
DELTA_LIGHTS = (
    {"type": "point", "position": [-20.0, 10.0, 45.0],
     "intensity": [3000.0, 2600.0, 2000.0]},
    {"type": "spot", "position": [30.0, 20.0, 80.0],
     "direction": [-0.3, -0.2, -1.0], "intensity": [12000.0, 12000.0,
                                                     14000.0],
     "inner_deg": 12.0, "outer_deg": 30.0},
    {"type": "directional", "direction": [0.4, 0.3, -1.0],
     "intensity": [0.4, 0.4, 0.45]})
_SPHERE_LOOKS = {0: "diffuse", 1: "mirror", 2: "glass", 3: "phong",
                 4: "light"}
# the default seven with two more made emissive (sphere 0 and the red
# sphere 5), by index
EMISSIVE_SPHERES = {0: (2.0, 1.6, 1.2), 5: (3.0, 0.6, 0.4)}
# the emission of the mesh triangles that lamp_triangles makes lights
LAMP_EMISSION = (4.0, 3.5, 3.0)


def write_lights_description(path, envmap=None, render=None) -> str:
    """A JSON description of the lights path's scene without its mesh: the
    default seven spheres with those in ``EMISSIVE_SPHERES`` made lights,
    the ``DELTA_LIGHTS``, the ``envmap`` file (written relative to the
    description's folder when it lies in it) and the ``render`` section
    (for example mis and light_sampling).  The mesh comes from the caller,
    its lamps from :func:`lamp_triangles`."""
    from .scene import Spheres
    s = Spheres.default_seven()
    spheres = []
    for i in range(s.count):
        look = "light" if i in EMISSIVE_SPHERES \
            else _SPHERE_LOOKS[int(s.refl[i])]
        e = {"center": s.center[i].tolist(), "radius": float(s.radius[i]),
             "color": s.color[i].tolist(), "material": look}
        if look == "light":
            e["emission"] = list(EMISSIVE_SPHERES.get(
                i, s.emission[i].tolist()))
        spheres.append(e)
    desc = {"spheres": spheres, "default_spheres": False,
            "lights": [dict(d) for d in DELTA_LIGHTS]}
    if envmap is not None:
        env = Path(envmap).resolve()
        base = Path(path).resolve().parent
        desc["envmap"] = env.name if env.parent == base else str(env)
    if render:
        desc["render"] = dict(render)
    Path(path).write_text(json.dumps(desc, indent=1))
    return str(path)


def lamp_triangles(n_tris: int, n_lamps: int):
    """(tri_refl [n_tris] i32, tri_color [n_tris, 3] f32) of a mesh with
    ``n_lamps`` of its triangles, taken with a stride through the triangle
    list, made LIGHT of emission ``LAMP_EMISSION``; the rest diffuse
    white, the default."""
    from .scene import LIGHT
    refl = np.zeros(n_tris, np.int32)
    color = np.ones((n_tris, 3), np.float32)
    lamps = np.arange(n_lamps) * (n_tris // n_lamps)
    refl[lamps] = LIGHT
    color[lamps] = LAMP_EMISSION
    return refl, color


# the textured scene: world units a texture repeat of the mesh's planar
# uvs, the texture ids (atlas order) and their wrap modes (0 repeat, 1
# clamp to edge, 2 mirrored repeat), the mesh's metal region (triangle
# centroids with x above it) and the tints
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
    """The textured scene's five maps, in ``TEX_*`` order, from numpy with
    ``seed``: an RGBA albedo (alpha 1 everywhere), a tangent-space normal
    map from a height field, a roughness (channel 0) and metalness
    (channel 1) map, an RGBA leaf whose alpha is below 0.5 on about half
    of its texels (outside an ellipse), and a 4x4 RGBA of constant alpha
    0.5 for the blend panes."""
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
    scene on the mesh (v0, v1, v2): the mesh gets planar uvs that repeat
    every ``UV_TILE`` units, the albedo and normal maps, and where its
    triangles' centroids have x > ``METAL_X`` a GGX conductor flagged
    metal under the roughness/metal map; above it float ``n_leaves``
    alpha-cutout leaf quads (the leaf map, clamped) and ``n_blend`` / 2
    upright blend panes of constant alpha 0.5, placed from ``seed`` over
    the mesh's height (the highest triangle over each of 64 x 64 bins) or
    over
    ``ground_z`` where that is higher (the top of the ground sphere of
    ``Spheres.default_seven``).  ``texture_px`` sizes the maps
    (:func:`scene_textures`)."""
    from .scene import DIFF, GGX
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
    no = np.full(t, -1, np.int32)
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
