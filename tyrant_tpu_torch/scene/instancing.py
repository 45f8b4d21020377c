"""Mesh instancing by world-space flattening.

Every instance's triangles are transformed on the host and ONE flat BVH
is built over the union, so the traversal kernels walk one table with no
per-instance re-transform.

``Transform`` is any [4,4] or [3,4] affine matrix (row-major, points as
column vectors: world = A @ obj + t).  Normals transform by the
inverse-transpose of A (non-uniform scales supported); winding flips under
negative determinants so backface culling keeps working.

The port's own copy of the JAX package's module; its arrays equal the
original's bit for bit (tests/test_torch_loaders.py).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np


@dataclasses.dataclass
class MeshAsset:
    """One instanceable mesh: corner positions + optional attributes.

    v0/v1/v2: [T, 3] corner positions (NOT edge form).
    tri_refl [T] i32, tri_color [T,3], tri_uv [T,3,2], tri_tex [T] (ids into
    ``textures``), textures: list of [H,W,3] f32, tri_vn [T,3,3].
    """

    v0: np.ndarray
    v1: np.ndarray
    v2: np.ndarray
    tri_refl: Optional[np.ndarray] = None
    tri_color: Optional[np.ndarray] = None
    tri_uv: Optional[np.ndarray] = None
    tri_tex: Optional[np.ndarray] = None
    textures: Optional[list] = None
    tri_vn: Optional[np.ndarray] = None
    tri_rough: Optional[np.ndarray] = None  # [T] f32 GGX roughness
    tri_ntex: Optional[np.ndarray] = None   # [T] i32 normal-map id, -1=none
    tri_rtex: Optional[np.ndarray] = None   # [T] i32 rough-map id, -1=none
    tri_blend: Optional[np.ndarray] = None  # [T] bool: stochastic alpha
    #   BLEND (glTF alphaMode BLEND / MTL d<1) vs the 0.5 MASK cutout
    tri_metal: Optional[np.ndarray] = None  # [T] bool: per-texel metalness
    #   (glTF mr-texture B channel; shade picks GGX w.p. metalness)
    tri_ior: Optional[np.ndarray] = None    # [T] f32 glass IOR for REFR
    #   triangles (KHR_materials_ior; default 1.2 = reference parity)
    tex_wraps: Optional[list] = None        # per-texture (wrapS, wrapT)
    #   parallel to ``textures`` (0 repeat / 1 clamp / 2 mirror)

    @classmethod
    def load(cls, path: str, scale: float = 1.0) -> "MeshAsset":
        """Load a mesh file (PLY/OBJ/STL) as an instanceable asset, with
        the same attribute extraction as Scene.load."""
        return _load_no_bvh(path, scale)

    @property
    def n_tris(self) -> int:
        return int(self.v0.shape[0])


def _load_no_bvh(path: str, scale: float) -> MeshAsset:
    """Scene.load's loader stage without the BVH build (instances rebuild
    one flat BVH over the union, so per-asset trees would be wasted)."""
    from .scene import _ply_has_attrs, load_mesh

    if path.endswith((".glb", ".gltf")):
        # a glTF file is itself a (possibly instanced) graph: pre-flatten
        # it into one asset so it can be re-instanced like any mesh
        from .gltf import load_gltf_asset
        return load_gltf_asset(path, scale=scale)

    tri_uv = tri_tex = textures = tri_color = tri_vn = None
    tri_refl = tri_rough = tri_ntex = tri_rtex = tri_blend = None
    tri_metal = None
    if path.endswith(".obj"):
        from .obj import load_obj_scene
        m = load_obj_scene(path)
        vertices, faces = m.vertices, m.faces
        tri_uv, tri_tex, textures = m.uvs, m.tri_tex, m.textures
        tri_color = m.tri_color
        tri_vn = m.normals
        tri_refl, tri_rough = m.tri_refl, m.tri_rough
        tri_ntex = m.tri_ntex
        tri_rtex = m.tri_rtex
        tri_blend = m.tri_blend
        tri_metal = m.tri_metal
    elif path.endswith(".ply") and _ply_has_attrs(path):
        from .ply import load_ply_attrs
        vertices, faces, vnorm, vcol = load_ply_attrs(path)
        if vnorm is not None:
            tri_vn = vnorm[faces]
        if vcol is not None:
            # per-triangle mean of the scanned vertex colors (scene.py)
            tri_color = vcol[faces].mean(axis=1).astype(np.float32)
    else:
        vertices, faces = load_mesh(path)
    vertices = vertices * np.float32(scale)
    return MeshAsset(v0=vertices[faces[:, 0]], v1=vertices[faces[:, 1]],
                     v2=vertices[faces[:, 2]], tri_color=tri_color,
                     tri_uv=tri_uv, tri_tex=tri_tex, textures=textures,
                     tri_vn=tri_vn, tri_refl=tri_refl, tri_rough=tri_rough,
                     tri_ntex=tri_ntex, tri_rtex=tri_rtex,
                     tri_blend=tri_blend, tri_metal=tri_metal)


def _as_affine(m) -> tuple[np.ndarray, np.ndarray]:
    m = np.asarray(m, np.float64)
    if m.shape == (4, 4):
        assert np.allclose(m[3], [0, 0, 0, 1]), \
            "bottom row of a 4x4 instance transform must be [0,0,0,1]"
        return m[:3, :3], m[:3, 3]
    if m.shape == (3, 4):
        return m[:, :3], m[:, 3]
    raise ValueError(f"instance transform must be [4,4] or [3,4], got {m.shape}")


def translate(t) -> np.ndarray:
    m = np.eye(4)
    m[:3, 3] = t
    return m


def scale(s) -> np.ndarray:
    m = np.eye(4)
    m[0, 0], m[1, 1], m[2, 2] = (s, s, s) if np.isscalar(s) else s
    return m


def rotate_y(theta: float) -> np.ndarray:
    c, s = np.cos(theta), np.sin(theta)
    m = np.eye(4)
    m[0, 0], m[0, 2], m[2, 0], m[2, 2] = c, s, -s, c
    return m


def flatten_instances(meshes: Sequence[MeshAsset],
                      instances: Sequence[tuple]) -> MeshAsset:
    """Flatten (mesh_id, transform) instances into one world-space asset.

    Attribute rules:
      * positions transform as points;
      * vertex normals by inverse-transpose (renormalised), so non-uniform
        scales shade correctly;
      * a negative-determinant transform (mirror) swaps two corners to
        preserve outward winding under the reference's backface culling
        (loader.h:28 det >= 1e-7);
      * texture lists merge with per-mesh id offsets;
      * attribute arrays merge to the union: meshes lacking an attribute
        get the defaults (white DIFF, no UV/tex/vn).
    """
    any_refl = any(m.tri_refl is not None for m in meshes)
    any_color = any(m.tri_color is not None for m in meshes)
    any_rough = any(m.tri_rough is not None for m in meshes)
    any_uv = any(m.tri_uv is not None for m in meshes)
    any_vn = any(m.tri_vn is not None for m in meshes)
    any_tex = any(m.textures for m in meshes)

    tex_offset = []
    textures: list = []
    tex_wraps: list = []
    for m in meshes:
        tex_offset.append(len(textures))
        if m.textures:
            textures.extend(m.textures)
            tex_wraps.extend(m.tex_wraps if m.tex_wraps is not None
                             else [(0, 0)] * len(m.textures))

    out_v0, out_v1, out_v2 = [], [], []
    out_refl, out_color, out_uv, out_tex, out_vn = [], [], [], [], []
    out_rough, out_ntex, out_rtex = [], [], []
    any_ntex = any(m.tri_ntex is not None for m in meshes)
    any_rtex = any(m.tri_rtex is not None for m in meshes)
    any_blend = any(m.tri_blend is not None for m in meshes)
    out_blend = []
    any_metal2 = any(m.tri_metal is not None for m in meshes)
    out_metal = []
    any_ior = any(m.tri_ior is not None for m in meshes)
    out_ior = []
    for mesh_id, xf in instances:
        m = meshes[mesh_id]
        a, t = _as_affine(xf)
        flip = np.linalg.det(a) < 0
        v0 = (m.v0 @ a.T + t).astype(np.float32)
        v1 = (m.v1 @ a.T + t).astype(np.float32)
        v2 = (m.v2 @ a.T + t).astype(np.float32)
        n = m.n_tris
        uv = (m.tri_uv if m.tri_uv is not None
              else np.zeros((n, 3, 2), np.float32))
        vn = m.tri_vn
        if vn is not None:
            ait = np.linalg.inv(a).T
            vn = vn @ ait.T
            ln = np.linalg.norm(vn, axis=2, keepdims=True)
            vn = (vn / np.maximum(ln, 1e-30)).astype(np.float32)
        elif any_vn:
            vn = np.zeros((n, 3, 3), np.float32)
        if flip:
            # swap corners 1<->2: e1' = old e2 etc; keeps cross(e1,e2)
            # pointing outward after the mirror
            v1, v2 = v2, v1
            uv = uv[:, [0, 2, 1]]
            if vn is not None:
                vn = vn[:, [0, 2, 1]]
        out_v0.append(v0)
        out_v1.append(v1)
        out_v2.append(v2)
        if any_refl:
            out_refl.append(m.tri_refl if m.tri_refl is not None
                            else np.zeros(n, np.int32))
        if any_color:
            out_color.append(m.tri_color if m.tri_color is not None
                             else np.ones((n, 3), np.float32))
        if any_rough:
            out_rough.append(m.tri_rough if m.tri_rough is not None
                             else np.full(n, 0.3, np.float32))
        if any_uv or any_tex:
            out_uv.append(uv)
            tt = (m.tri_tex.astype(np.int64) + tex_offset[mesh_id]
                  if m.tri_tex is not None else np.full(n, -1, np.int64))
            out_tex.append(np.where(tt >= 0, tt, -1).astype(np.int32))
            nt = (m.tri_ntex.astype(np.int64) + tex_offset[mesh_id]
                  if m.tri_ntex is not None else np.full(n, -1, np.int64))
            out_ntex.append(np.where(nt >= 0, nt, -1).astype(np.int32))
            rt = (m.tri_rtex.astype(np.int64) + tex_offset[mesh_id]
                  if m.tri_rtex is not None else np.full(n, -1, np.int64))
            out_rtex.append(np.where(rt >= 0, rt, -1).astype(np.int32))
        if any_vn:
            out_vn.append(vn)
        if any_blend:
            out_blend.append(m.tri_blend if m.tri_blend is not None
                             else np.zeros(n, bool))
        if any_metal2:
            out_metal.append(m.tri_metal if m.tri_metal is not None
                             else np.zeros(n, bool))
        if any_ior:
            out_ior.append(m.tri_ior if m.tri_ior is not None
                           else np.full(n, 1.2, np.float32))

    cat = np.concatenate
    return MeshAsset(
        v0=cat(out_v0), v1=cat(out_v1), v2=cat(out_v2),
        tri_refl=cat(out_refl) if any_refl else None,
        tri_color=cat(out_color) if any_color else None,
        tri_uv=cat(out_uv) if (any_uv or any_tex) else None,
        tri_tex=cat(out_tex) if (any_uv or any_tex) else None,
        textures=textures if any_tex else None,
        tex_wraps=(tex_wraps if any_tex and any(w != (0, 0)
                                                for w in tex_wraps)
                   else None),
        tri_vn=cat(out_vn) if any_vn else None,
        tri_rough=cat(out_rough) if any_rough else None,
        tri_ntex=cat(out_ntex) if any_ntex else None,
        tri_rtex=cat(out_rtex) if any_rtex else None,
        tri_blend=cat(out_blend) if any_blend else None,
        tri_metal=cat(out_metal) if any_metal2 else None,
        tri_ior=cat(out_ior) if any_ior else None)
