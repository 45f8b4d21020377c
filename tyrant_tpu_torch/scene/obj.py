"""Wavefront OBJ loader (pure numpy), with UV / MTL material support.

The `v/vt/vn` index forms, `mtllib`/`usemtl` records and the MTL
`Kd`/`Ke`/`Ni`/`Pr`/`Pm`/`d`/`map_*` statements become per-triangle
materials, normals and texture ids.

`load_obj` keeps the minimal (vertices, faces) contract for geometry-only
callers; `load_obj_scene` returns the full per-triangle material record.

The port's own copy of the JAX package's loader; its arrays equal the
original's bit for bit (tests/test_torch_loaders.py).
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np


@dataclasses.dataclass
class ObjMesh:
    """Triangulated OBJ contents in per-triangle form."""

    vertices: np.ndarray        # [V, 3] f32
    faces: np.ndarray           # [F, 3] i32 position indices
    uvs: np.ndarray | None      # [F, 3, 2] f32 per-corner texcoords (or None)
    tri_color: np.ndarray | None  # [F, 3] f32 Kd per triangle (or None)
    tri_tex: np.ndarray | None  # [F] i32 texture index, -1 = none (or None)
    textures: list | None       # list of [H, W, 3] f32 linear images
    normals: np.ndarray | None = None  # [F, 3, 3] f32 per-corner vn
    tri_refl: np.ndarray | None = None  # [F] i32 material type (or None)
    tri_rough: np.ndarray | None = None  # [F] f32 GGX roughness (or None)
    tri_ntex: np.ndarray | None = None  # [F] i32 normal-map id, -1 = none
    tri_rtex: np.ndarray | None = None  # [F] i32 roughness-map id, -1 = none
    tri_blend: np.ndarray | None = None  # [F] bool stochastic alpha (d < 1)
    tri_metal: np.ndarray | None = None  # [F] bool per-texel metalness


# scene.scene.GGX, duplicated to avoid a circular import (scene.py imports
# this module inside Scene.load)
_GGX = 5
_LIGHT = 4


def _parse_mtl(path: str):
    """Returns {material name: [Kd rgb, map_Kd path|None, Pr|None, Pm,
    normal-map path|None, roughness-map path|None, alpha-map path|None,
    Ke rgb|None]}.

    ...plus constant dissolve ``d`` (or ``Tr``) as slot 8.

    ``Pr`` (roughness) and ``Pm`` (metallic) are the common PBR extension
    keys; a metallic material (Pm > 0.5) shades as the GGX rough conductor
    (beyond-reference, see ops/sampling.py ggx_*).  ``map_Kn`` / ``norm``
    / ``map_bump`` / ``bump`` name a tangent-space normal map."""
    mats = {}
    cur = None
    base = os.path.dirname(path)
    with open(path, "r", errors="replace") as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "newmtl" and len(parts) > 1:
                cur = parts[1]
                mats[cur] = [(1.0, 1.0, 1.0), None, None, 0.0, None, None,
                             None, None, 1.0, None]
            elif parts[0] == "Kd" and cur and len(parts) >= 4:
                mats[cur][0] = (float(parts[1]), float(parts[2]),
                                float(parts[3]))
            elif parts[0] == "map_Kd" and cur and len(parts) > 1:
                # last token: map_Kd may carry -o/-s options we ignore
                mats[cur][1] = os.path.join(base, parts[-1])
            elif parts[0] == "Pr" and cur and len(parts) > 1:
                mats[cur][2] = float(parts[1])
            elif parts[0] == "Pm" and cur and len(parts) > 1:
                mats[cur][3] = float(parts[1])
            elif parts[0] in ("map_Kn", "norm", "map_bump", "bump") \
                    and cur and len(parts) > 1:
                mats[cur][4] = os.path.join(base, parts[-1])
            elif parts[0] == "map_Pr" and cur and len(parts) > 1:
                mats[cur][5] = os.path.join(base, parts[-1])
            elif parts[0] == "map_Pm" and cur and len(parts) > 1:
                mats[cur][9] = os.path.join(base, parts[-1])
            elif parts[0] == "map_d" and cur and len(parts) > 1:
                mats[cur][6] = os.path.join(base, parts[-1])
            elif parts[0] == "d" and cur and len(parts) > 1:
                mats[cur][8] = float(parts[1])
            elif parts[0] == "Tr" and cur and len(parts) > 1:
                # inverted-dissolve spelling some exporters use
                mats[cur][8] = 1.0 - float(parts[1])
            elif parts[0] == "Ke" and cur and len(parts) >= 4:
                ke = (float(parts[1]), float(parts[2]), float(parts[3]))
                if max(ke) > 0.0:
                    mats[cur][7] = ke
    return mats


def load_obj_scene(path: str) -> ObjMesh:
    """Full OBJ parse: fan triangulation, negative indices, vt, mtllib."""
    verts: list = []
    vts: list = []
    vns: list = []
    faces: list = []
    face_uv: list = []
    face_vn: list = []
    face_mat: list = []
    mats: dict = {}
    cur_mat = None
    any_uv = False
    any_vn = False
    base = os.path.dirname(path)
    with open(path, "r", errors="replace") as f:
        for line in f:
            if line.startswith("v "):
                p = line.split()
                verts.append((float(p[1]), float(p[2]), float(p[3])))
            elif line.startswith("vt "):
                p = line.split()
                vts.append((float(p[1]),
                            float(p[2]) if len(p) > 2 else 0.0))
            elif line.startswith("vn "):
                p = line.split()
                vns.append((float(p[1]), float(p[2]), float(p[3])))
            elif line.startswith("mtllib "):
                rest = line.split(None, 1)[1].strip() \
                    if len(line.split(None, 1)) > 1 else ""
                mp = os.path.join(base, rest)
                if rest and os.path.exists(mp):
                    try:
                        mats.update(_parse_mtl(mp))
                    except Exception:
                        pass  # malformed MTL: shade untextured (degrade)
            elif line.startswith("usemtl "):
                parts = line.split(None, 1)
                cur_mat = parts[1].strip() if len(parts) > 1 else None
            elif line.startswith("f "):
                idx = []
                uvi = []
                nvi = []
                for tok in line.split()[1:]:
                    comps = tok.split("/")
                    k = int(comps[0])
                    idx.append(k - 1 if k > 0 else len(verts) + k)
                    if len(comps) > 1 and comps[1]:
                        t = int(comps[1])
                        uvi.append(t - 1 if t > 0 else len(vts) + t)
                    else:
                        uvi.append(-1)
                    if len(comps) > 2 and comps[2]:
                        nn = int(comps[2])
                        nvi.append(nn - 1 if nn > 0 else len(vns) + nn)
                    else:
                        nvi.append(-1)
                for j in range(1, len(idx) - 1):
                    faces.append((idx[0], idx[j], idx[j + 1]))
                    face_uv.append((uvi[0], uvi[j], uvi[j + 1]))
                    face_vn.append((nvi[0], nvi[j], nvi[j + 1]))
                    face_mat.append(cur_mat)
                    any_uv = any_uv or uvi[0] >= 0
                    any_vn = any_vn or nvi[0] >= 0
    if not verts:
        raise ValueError(f"{path}: no vertices")

    vertices = np.asarray(verts, np.float32)
    faces_a = np.asarray(faces, np.int32).reshape(-1, 3)
    if faces_a.size and (faces_a.min() < 0
                         or faces_a.max() >= len(verts)):
        # fail fast (C12): an out-of-range face would otherwise surface
        # as a numpy IndexError deep inside Scene.load
        raise ValueError(f"{path}: face references vertex "
                         f"{int(faces_a.max())} of {len(verts)}")
    f_count = faces_a.shape[0]

    uvs = None
    if any_uv and vts:
        vt_a = np.asarray(vts, np.float32)
        fuv = np.asarray(face_uv, np.int64).reshape(-1, 3)
        uvs = np.zeros((f_count, 3, 2), np.float32)
        valid = fuv >= 0
        uvs[valid] = vt_a[np.clip(fuv, 0, vt_a.shape[0] - 1)][valid]

    normals = None
    if any_vn and vns:
        vn_a = np.asarray(vns, np.float32)
        fvn = np.asarray(face_vn, np.int64).reshape(-1, 3)
        normals = np.zeros((f_count, 3, 3), np.float32)
        valid = fvn >= 0
        normals[valid] = vn_a[np.clip(fvn, 0, vn_a.shape[0] - 1)][valid]

    tri_color = None
    tri_tex = None
    textures = None
    tri_refl = None
    tri_rough = None
    tri_ntex = None
    tri_rtex = None
    tri_blend = None
    tri_metal = None
    if mats and any(m is not None for m in face_mat):
        from .texture import load_texture
        tri_color = np.ones((f_count, 3), np.float32)
        tri_tex = np.full(f_count, -1, np.int32)
        tri_ntex = np.full(f_count, -1, np.int32)
        tri_rtex = np.full(f_count, -1, np.int32)
        tri_blend = np.zeros(f_count, bool)
        tri_metal_a = np.zeros(f_count, bool)
        any_metal = any(rec[3] > 0.5 for rec in mats.values())
        any_emissive = any(rec[7] is not None for rec in mats.values())
        if any_metal or any_emissive:
            tri_refl = np.zeros(f_count, np.int32)
            tri_rough = np.full(f_count, 0.3, np.float32)
        tex_paths: dict = {}
        textures = []

        def rgba_combined(kd_path, d_path):
            """Albedo rgb + cutout alpha in ONE [H,W,4] image, so shade
            reads both from a single atlas tap (atlas lane 3 = alpha).
            The alpha map (map_d) uses its alpha channel if present, else
            its red channel, resized to the albedo resolution."""
            from PIL import Image
            from .texture import load_texture
            rgb = load_texture(kd_path, srgb=True) if kd_path else None
            with Image.open(d_path) as dm:
                if "A" in dm.getbands():
                    a_im = dm.getchannel("A")
                else:
                    a_im = dm.convert("L")
                if rgb is not None and a_im.size != (rgb.shape[1],
                                                     rgb.shape[0]):
                    a_im = a_im.resize((rgb.shape[1], rgb.shape[0]))
                alpha = np.asarray(a_im, np.uint8).astype(np.float32) / 255.0
            if rgb is None:
                rgb = np.ones((*alpha.shape, 3), np.float32)
            return np.concatenate([rgb, alpha[:, :, None]], axis=2)

        def tex_id(tp, srgb):
            # one atlas for albedo AND normal maps; normal maps decode raw
            # (their channels are vector components, not radiance), so the
            # dedup key includes the decode mode
            key = (tp, srgb)
            if key not in tex_paths:
                try:
                    tex_paths[key] = len(textures)
                    textures.append(load_texture(tp, srgb=srgb))
                except Exception as e:
                    # undecodable image (or no PIL): shade this
                    # material untextured instead of failing the
                    # whole geometry load
                    import sys
                    print(f"warning: texture {tp!r} failed to load "
                          f"({e}); shading untextured", file=sys.stderr)
                    tex_paths[key] = -1
            return tex_paths[key]

        for i, name in enumerate(face_mat):
            rec = mats.get(name) if name else None
            if rec is None:
                continue
            tri_color[i] = rec[0]
            if rec[7] is not None:
                # MTL Ke: emissive material -> LIGHT triangle; its
                # "colour" IS the radiant exitance (scene.py tri-lights:
                # NEE target + direct-hit emission, both read tri_color)
                tri_refl[i] = _LIGHT
                tri_color[i] = rec[7]
            elif any_metal and rec[3] > 0.5:
                tri_refl[i] = _GGX
                tri_rough[i] = rec[2] if rec[2] is not None else 0.3
            if rec[6] and os.path.exists(rec[6]):
                # map_d: the material's atlas entry becomes the COMBINED
                # rgb+alpha image (key includes the pair so a shared
                # map_Kd without map_d stays a separate rgb entry)
                key = ("rgba", rec[1], rec[6])
                if key not in tex_paths:
                    try:
                        tex_paths[key] = len(textures)
                        textures.append(rgba_combined(
                            rec[1] if rec[1] and os.path.exists(rec[1])
                            else None, rec[6]))
                    except Exception as e:
                        import sys
                        print(f"warning: alpha map {rec[6]!r} failed to "
                              f"load ({e}); shading opaque", file=sys.stderr)
                        tex_paths[key] = -1
                tri_tex[i] = tex_paths[key]
            elif rec[1] and os.path.exists(rec[1]):
                tri_tex[i] = tex_id(rec[1], srgb=True)
            is_light = tri_refl is not None and tri_refl[i] == _LIGHT
            if rec[8] < 1.0 and not is_light:
                # constant dissolve d < 1: stochastic transparency
                # (render.py BLEND).  With no alpha map a shared 1x1
                # white texel carries the alpha; with one, the texel
                # alpha wins and d is ignored (same degradation as the
                # glTF factor-alpha-with-texture case, scene/gltf.py).
                tri_blend[i] = True
                if tri_tex[i] < 0:
                    key = ("const_d", round(rec[8], 6))
                    if key not in tex_paths:
                        tex_paths[key] = len(textures)
                        textures.append(np.asarray(
                            [[[1.0, 1.0, 1.0, rec[8]]]], np.float32))
                    tri_tex[i] = tex_paths[key]
            if rec[4] and os.path.exists(rec[4]):
                tri_ntex[i] = tex_id(rec[4], srgb=False)
            pm_map = rec[9] if rec[9] and os.path.exists(rec[9]) else None
            pr_map = rec[5] if rec[5] and os.path.exists(rec[5]) else None
            if pm_map is not None and not is_light:
                # per-texel metalness (map_Pm, like the glTF mr B channel):
                # pack roughness (map_Pr red, or the scalar Pr) into ch0
                # and metalness (map_Pm red) into ch1 of ONE texel row —
                # shade stochastically picks GGX w.p. metalness (render.py)
                rough_c = rec[2] if rec[2] is not None else 0.3
                key = ("rm", pr_map, pm_map, round(rough_c, 5))
                if key not in tex_paths:
                    try:
                        from .texture import load_texture
                        pm = load_texture(pm_map, srgb=False)
                        if pr_map is not None:
                            pr = load_texture(pr_map, srgb=False)
                            if pr.shape[:2] != pm.shape[:2]:
                                from PIL import Image
                                im = Image.fromarray(
                                    (np.clip(pm[:, :, 0], 0, 1)
                                     * 255).astype(np.uint8))
                                im = im.resize((pr.shape[1], pr.shape[0]))
                                pm_r = (np.asarray(im, np.float32)
                                        / 255.0)
                            else:
                                pm_r = pm[:, :, 0]
                            rough_ch = pr[:, :, 0]
                        else:
                            pm_r = pm[:, :, 0]
                            rough_ch = np.full_like(pm_r, rough_c)
                        tex_paths[key] = len(textures)
                        textures.append(np.stack(
                            [rough_ch, pm_r, rough_ch],
                            axis=2).astype(np.float32))
                    except Exception as e:
                        import sys
                        print(f"warning: metal map {pm_map!r} failed to "
                              f"load ({e}); shading by scalar Pm",
                              file=sys.stderr)
                        tex_paths[key] = -1
                if tex_paths[key] >= 0:
                    tri_rtex[i] = tex_paths[key]
                    tri_metal_a[i] = True
                    if tri_refl is None:
                        tri_refl = np.zeros(f_count, np.int32)
                        tri_rough = np.full(f_count, 0.3, np.float32)
                    tri_refl[i] = _GGX
                else:
                    pm_map = None  # decode failed: fall back to map_Pr
            if pm_map is None and pr_map is not None:
                tri_rtex[i] = tex_id(pr_map, srgb=False)
                if tri_refl is None:
                    # a roughness map implies a GGX surface even without Pm
                    tri_refl = np.zeros(f_count, np.int32)
                    tri_rough = np.full(f_count, 0.3, np.float32)
                tri_refl[i] = _GGX
        if uvs is None and textures and (tri_tex >= 0).any():
            # a synthesized 1x1 texel (constant d) on a UV-less OBJ: any
            # parameterisation samples the single texel, but the atlas
            # gate (scene.py has_atlas) needs tri_uv present
            uvs = np.zeros((f_count, 3, 2), np.float32)
        if not textures:
            textures = None
            tri_tex = None
            tri_ntex = None
            tri_rtex = None
        else:
            if (tri_ntex < 0).all():
                tri_ntex = None
            if (tri_rtex < 0).all():
                tri_rtex = None
        if not tri_blend.any():
            tri_blend = None
        tri_metal = tri_metal_a if tri_metal_a.any() else None

    return ObjMesh(vertices=vertices, faces=faces_a, uvs=uvs,
                   tri_color=tri_color, tri_tex=tri_tex, textures=textures,
                   normals=normals, tri_refl=tri_refl, tri_rough=tri_rough,
                   tri_ntex=tri_ntex, tri_rtex=tri_rtex,
                   tri_blend=tri_blend,
                   tri_metal=tri_metal)


def load_obj(path: str):
    """Returns (vertices [V,3] float32, faces [F,3] int32)."""
    m = load_obj_scene(path)
    return m.vertices, m.faces
