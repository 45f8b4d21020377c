"""Scene files written from arrays: a binary PLY mesh (with smooth vertex
normals if asked), a small OBJ/MTL asset, a JSON description that places
a mesh and instances of the asset, a sphere-free glTF binary, a
procedural HDR sky as an equirectangular PFM, and a JSON description of
a lit scene (emissive spheres, point/spot/directional lights, the
envmap) with the LIGHT triangles of its mesh (``lamp_triangles``).

``chip_smoke.py`` and the CPU tests build the loaded-scene and the lights
paths from these files, so they need no download; the loaders read them
back as they read any other file.
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
