"""Scene container, the port of ``tyrant_tpu/scene/scene.py``: analytic
spheres plus one triangle mesh (or the flattened union of instanced
meshes) loaded from PLY, OBJ/MTL, STL, glTF or a JSON description, with
per-triangle DIFF/SPEC/REFR/PHONG/GGX/RREFR/LIGHT materials, a
per-triangle glass IOR, smooth vertex normals, textures (albedo with
cutout alpha, tangent-space normal maps, roughness and metalness maps,
stochastic alpha blend, per-texture wrap modes, a mip pyramid), and the
lights: emissive spheres and triangles, point/spot/directional delta
lights and an equirectangular environment map, with the per-light power
table and the alias rows of the power and environment importance
samplers.

Host loading and packing are the JAX package's numpy code, so every
table equals the JAX one bit for bit.
"""

from __future__ import annotations

import dataclasses
import os
import subprocess
import sys
from typing import Optional

import numpy as np
import torch

from ..config import BVHConfig
from ..ops.traverse import LEAF_WIDTH, BVHDevice
from . import ply
from .bvh import BVHArrays, build_bvh, bvh_stats, pack_meta
from .envlight import LUM_RGB, build_alias, env_tables

DIFF, SPEC, REFR, PHONG, LIGHT, GGX = 0, 1, 2, 3, 4, 5
# shade-only pseudo-materials, never stored in a scene table: a fog medium
# event and an alpha-cutout pass-through (the JAX package's ids)
FOG, PASS = 6, 7
# rough dielectric ("frosted glass")
RREFR = 8


@dataclasses.dataclass
class Spheres:
    """Host-side analytic sphere list."""

    center: np.ndarray    # [S, 3] f32
    radius: np.ndarray    # [S] f32
    color: np.ndarray     # [S, 3] f32
    emission: np.ndarray  # [S, 3] f32
    refl: np.ndarray      # [S] i32 (DIFF/SPEC/REFR/PHONG/LIGHT/GGX/RREFR)
    # perceptual roughness for GGX/RREFR spheres (alpha = roughness^2);
    # None -> 0.3 everywhere
    roughness: Optional[np.ndarray] = None  # [S] f32

    @classmethod
    def default_seven(cls) -> "Spheres":
        """The reference's Cornell-style arrangement."""
        rows = [
            # radius, position,            color,            emission,  refl
            (16.5, (0, 40, 16.5), (1, 1, 1), (0, 0, 0), DIFF),
            (16.5, (40, 0, 16.5), (0.5, 0.5, 0.06), (0, 0, 0), REFR),
            (16.5, (-40, -50, 36.5), (0.6, 0.5, 0.4), (0, 0, 0), PHONG),
            (16.5, (-40, -50, 16.5), (0.6, 0.5, 0.4), (0, 0, 0), SPEC),
            (1e4, (0, 0, -1e4 - 20), (1, 1, 1), (0, 0, 0), DIFF),
            (20.0, (0, -80, 20), (1.0, 0.0, 0.0), (0, 0, 0), DIFF),
            (9.0, (0, -80, 120.0), (0.0, 1.0, 0.0), (3, 3, 3), LIGHT),
        ]
        return cls(
            center=np.array([r[1] for r in rows], np.float32),
            radius=np.array([r[0] for r in rows], np.float32),
            color=np.array([r[2] for r in rows], np.float32),
            emission=np.array([r[3] for r in rows], np.float32),
            refl=np.array([r[4] for r in rows], np.int32),
        )

    @property
    def count(self):
        return self.center.shape[0]


# Delta-light kinds
DL_POINT, DL_SPOT, DL_DIRECTIONAL = 0, 1, 2


@dataclasses.dataclass
class DeltaLights:
    """Zero-area analytic lights: point / spot / directional, reachable
    only through next-event estimation (a BSDF ray never hits one), so
    they join the NEE light pick beside the area lights with an MIS
    weight of 1.

    ``intensity`` is radiant intensity (W/sr) for point/spot lights and
    irradiance on a perpendicular surface for directional lights;
    ``direction`` points FROM the light INTO the scene.
    """

    kind: np.ndarray       # [L] i32 (DL_POINT/DL_SPOT/DL_DIRECTIONAL)
    position: np.ndarray   # [L, 3] f32 (unused for directional)
    direction: np.ndarray  # [L, 3] f32 (unused for point)
    intensity: np.ndarray  # [L, 3] f32
    cos_inner: np.ndarray  # [L] f32 (spot cone; 1.0 elsewhere)
    cos_outer: np.ndarray  # [L] f32

    @property
    def count(self):
        return int(self.kind.shape[0])

    @classmethod
    def from_specs(cls, specs) -> "DeltaLights":
        """Build from a list of dicts (the JSON scene-description form):
        ``{"type": "point"|"spot"|"directional", "position": [x,y,z],
        "direction": [x,y,z], "intensity": [r,g,b], "inner_deg": a,
        "outer_deg": b}``."""
        kinds, pos, dirs, inten, ci, co = [], [], [], [], [], []
        names = {"point": DL_POINT, "spot": DL_SPOT,
                 "directional": DL_DIRECTIONAL}
        for s in specs:
            t = s["type"]
            if t not in names:
                raise ValueError(f"unknown delta light type {t!r}")
            k = names[t]
            kinds.append(k)
            if k != DL_DIRECTIONAL and "position" not in s:
                raise ValueError(f"{t} light requires a position")
            if k != DL_POINT and "direction" not in s:
                raise ValueError(f"{t} light requires a direction")
            pos.append(s.get("position", (0.0, 0.0, 0.0)))
            d = np.asarray(s.get("direction", (0.0, 0.0, -1.0)), np.float64)
            n = np.linalg.norm(d)
            if k != DL_POINT and n < 1e-12:
                raise ValueError(f"{t} light direction must be non-zero")
            dirs.append(d / max(n, 1e-12))
            inten.append(s.get("intensity", (1.0, 1.0, 1.0)))
            if k == DL_SPOT:
                outer = float(s.get("outer_deg", 30.0))
                inner = float(s.get("inner_deg", outer))
                if not 0.0 < outer <= 90.0 or inner > outer:
                    raise ValueError(
                        "spot cone needs 0 < inner_deg <= outer_deg <= 90")
                ci.append(np.cos(np.radians(inner)))
                co.append(np.cos(np.radians(outer)))
            else:
                ci.append(1.0)
                co.append(1.0)
        return cls(kind=np.asarray(kinds, np.int32),
                   position=np.asarray(pos, np.float32).reshape(-1, 3),
                   direction=np.asarray(dirs, np.float32).reshape(-1, 3),
                   intensity=np.asarray(inten, np.float32).reshape(-1, 3),
                   cos_inner=np.asarray(ci, np.float32),
                   cos_outer=np.asarray(co, np.float32))

    def pack(self) -> np.ndarray:
        """[L, 12] device rows: kind, pos.xyz, dir.xyz, intensity.rgb,
        cos_inner, cos_outer (read by shade's NEE pick)."""
        out = np.zeros((self.count, 12), np.float32)
        out[:, 0] = self.kind.astype(np.float32)
        out[:, 1:4] = self.position
        out[:, 4:7] = self.direction
        out[:, 7:10] = self.intensity
        out[:, 10] = self.cos_inner
        out[:, 11] = self.cos_outer
        return out


@dataclasses.dataclass
class SceneData:
    """Device-resident scene tables read by the render step.

    tri_shade [T+pad, 8]: geometric normal.xyz, refl, color.rgb (a LIGHT
        triangle's emission), lane 7 (GGX/RREFR perceptual roughness, a
        REFR triangle's IOR, or a LIGHT triangle's area
        0.5 |cross(e1, e2)|, which the MIS emitter-hit pdf reads)
    sphere_table [max(S, 1), 12]: center.xyz, radius, color.rgb,
        emission.rgb, refl, roughness (one inert row when S = 0)
        The refl lane carries +16 on a stochastic-blend triangle (only
        under ``has_blend``) and +32 on a metal-mapped GGX triangle (only
        under ``has_metal_maps``); shade strips both before comparing.
    tri_attr [T+pad, 32] with smooth normals, textures or maps, else
        [4, 32] zeros: v0.xyz, s1.xyz, s2.xyz (the dual basis of the
        edges: barycentrics from the hit point with two dots), uv0,
        duv1, duv2 (9:15), albedo texture id (15), n0.xyz, dn1.xyz,
        dn2.xyz, smooth flag (25), normal-map id (26, -1 on a degenerate
        uv), the uv tangent (27:30), its handedness (30), rough-map id
        (31); ids -1 where absent
    tex_data [N+1, 4]: the texel atlas (``TextureAtlas.pack(mips=True)``:
        rgb and cutout alpha, row 0 white; the mip levels after every base
        image), [1, 4] ones without textures.  ``tex_meta`` holds one
        static entry a texture, (offset, height, width, wrap_s, wrap_t,
        ((offset, height, width) a mip level, level 0 first)), () without
    tri_lights [K, 13] (original triangle order), [1, 13] zeros when
        K = n_tri_lights = 0: v0.xyz, e1.xyz, e2.xyz, emission.rgb, area
    delta_lights [L, 12] (``DeltaLights.pack``), [1, 12] zeros when L =
        n_delta_lights = 0
    light_powers [n_lights] in the pick order (emissive spheres, emissive
        triangles, delta lights): luminance x area (x the solid angle of
        a delta light), [1] zeros without lights; ``light_cdf`` and
        ``light_inv_pdf`` [n_lights] are the power pick's CDF and
        1 / max(pdf, 1e-30) under the 0.75 power + 0.25 uniform mixture,
        ``light_total_power`` the sum, all derived from it at upload
    light_alias [n_lights, 4] beyond 64 lights, else [1, 4] zeros: Vose
        keep probability, alias index, 1/pdf of each outcome
    env_data [H*W+1, 4]: row 0 a neutral fallback, then the equirect
        radiance rgb and, in lane 3, the texel's solid-angle pdf; [1, 4]
        ones without an envmap.  env_alias [H*W, 12] (``envlight``), [1,
        12] zeros without.  env_meta (height, width), () without.

    The flags and counts are host values; the render step gates each term
    on them in Python, so a scene without a feature issues no op for it.
    The texture gates: ``has_albedo_tex`` (``has_textures``),
    ``has_normal_maps``, ``has_rough_maps``, ``has_alpha_tex`` (an albedo
    texture's alpha is below 1 somewhere: cutout), ``has_blend`` (needs
    the alpha taps) and ``has_metal_maps`` (needs the rough-map taps).
    ``tri_default_mat``: every triangle is the default material (DIFF,
    colour 1, roughness 0.3: no per-triangle material or colour, no smooth
    normals, textures or maps), so shade needs only a hit triangle's geometric normal, which
    the traversal kernel can return (``use_kernel_normals``).
    """

    bvh: BVHDevice
    sphere_center: torch.Tensor    # [S, 3]
    sphere_radius: torch.Tensor    # [S]
    sphere_emission: torch.Tensor  # [S, 3]
    light_index: int               # the first emissive sphere, or -1
    tri_shade: torch.Tensor        # [T+pad, 8] (leaf order)
    sphere_table: torch.Tensor     # [max(S, 1), 12]
    tri_attr: torch.Tensor         # [T+pad, 32] or [4, 32]
    smooth_normals: bool = False
    has_ggx: bool = False
    has_rrefr: bool = False
    has_var_ior: bool = False
    tri_default_mat: bool = False
    light_indices: tuple = ()      # every emissive sphere
    tri_lights: Optional[torch.Tensor] = None
    n_tri_lights: int = 0
    delta_lights: Optional[torch.Tensor] = None
    n_delta_lights: int = 0
    light_powers: Optional[torch.Tensor] = None
    light_cdf: Optional[torch.Tensor] = None
    light_inv_pdf: Optional[torch.Tensor] = None
    light_total_power: Optional[torch.Tensor] = None
    light_alias: Optional[torch.Tensor] = None
    env_data: Optional[torch.Tensor] = None
    env_alias: Optional[torch.Tensor] = None
    env_meta: tuple = ()
    tex_data: Optional[torch.Tensor] = None
    tex_meta: tuple = ()
    has_albedo_tex: bool = False
    has_normal_maps: bool = False
    has_rough_maps: bool = False
    has_alpha_tex: bool = False
    has_blend: bool = False
    has_metal_maps: bool = False

    @property
    def n_spheres(self) -> int:
        return int(self.sphere_center.shape[0])

    @property
    def has_envmap(self) -> bool:
        return len(self.env_meta) > 0

    @property
    def has_textures(self) -> bool:
        """Albedo textures present (the colour taps' gate)."""
        return self.has_albedo_tex


@dataclasses.dataclass
class Scene:
    """Host-side scene: load, build, upload."""

    spheres: Spheres
    tri_vert: np.ndarray  # [T, 3] (original order)
    tri_e1: np.ndarray
    tri_e2: np.ndarray
    bvh: Optional[BVHArrays]
    stats: dict
    tri_refl: Optional[np.ndarray] = None   # [T] i32, default DIFF
    tri_color: Optional[np.ndarray] = None  # [T, 3] f32, default white
    tri_uv: Optional[np.ndarray] = None     # [T, 3, 2] per-corner texcoords
    tri_tex: Optional[np.ndarray] = None    # [T] i32 texture id, -1 = none
    textures: Optional[list] = None         # list of [H, W, 3] f32 linear
    tri_vn: Optional[np.ndarray] = None     # [T, 3, 3] per-corner normals
    envmap: Optional[np.ndarray] = None     # [H, W, 3] equirect radiance
    tri_rough: Optional[np.ndarray] = None  # [T] f32 GGX roughness
    tri_ntex: Optional[np.ndarray] = None   # [T] i32 normal-map id, -1=none
    tri_rtex: Optional[np.ndarray] = None   # [T] i32 rough-map id, -1=none
    tri_blend: Optional[np.ndarray] = None  # [T] bool stochastic alpha BLEND
    tri_metal: Optional[np.ndarray] = None  # [T] bool per-texel metalness
    tri_ior: Optional[np.ndarray] = None    # [T] f32 glass IOR (REFR tris)
    # per-texture (wrap_s, wrap_t) parallel to ``textures``
    texture_wraps: Optional[list] = None
    delta_lights: Optional[DeltaLights] = None  # point/spot/directional

    @classmethod
    def load(cls, path: Optional[str] = None,
             spheres: Optional[Spheres] = None,
             bvh_cfg: BVHConfig = BVHConfig(),
             scale: float = 1.0,
             builder: str = "auto",
             envmap=None,
             delta_lights: Optional[DeltaLights] = None) -> "Scene":
        """Load a mesh file (.ply, .obj with its .mtl, .stl, .glb/.gltf)
        plus spheres and build the BVH; a ``.json`` path is a scene
        description (``description.load_description``), whose scene this
        returns.  ``path=None`` gives a spheres-only scene, and a missing
        file a scene without primitives and a warning.
        builder: "auto" (native C++ if it builds), "numpy" or "native"."""
        if path is not None and path.endswith(".json"):
            from .description import load_description
            sc = load_description(path, builder=builder,
                                  bvh_cfg=bvh_cfg).scene
            return _override(sc, spheres, envmap, delta_lights)
        if path is not None and path.endswith((".glb", ".gltf")):
            from .gltf import load_gltf_bundle
            sc = load_gltf_bundle(path, builder=builder, scale=scale,
                                  bvh_cfg=bvh_cfg).scene
            return _override(sc, spheres, envmap, delta_lights)
        spheres = spheres or Spheres.default_seven()
        if isinstance(envmap, str):
            from .texture import load_texture
            envmap = load_texture(envmap)
        if path is not None and not os.path.exists(path):
            print(f"warning: scene file {path!r} not found; "
                  "loading scene without mesh primitives", file=sys.stderr)
            path = None
        if path is None:
            z = np.zeros((0, 3), np.float32)
            return cls(spheres, z, z, z, None, {"nodes": 0}, envmap=envmap,
                       delta_lights=delta_lights)

        from .instancing import MeshAsset
        m = MeshAsset.load(path, scale=scale)
        s = cls.from_triangles(
            m.v0, m.v1, m.v2, spheres=spheres, bvh_cfg=bvh_cfg,
            builder=builder, tri_refl=m.tri_refl, tri_color=m.tri_color,
            tri_uv=m.tri_uv, tri_tex=m.tri_tex, textures=m.textures,
            tri_vn=m.tri_vn, envmap=envmap, tri_rough=m.tri_rough,
            tri_ntex=m.tri_ntex, tri_rtex=m.tri_rtex, tri_blend=m.tri_blend,
            tri_metal=m.tri_metal, delta_lights=delta_lights)
        return s

    @classmethod
    def from_triangles(cls, v0, v1, v2, spheres: Optional[Spheres] = None,
                       bvh_cfg: BVHConfig = BVHConfig(),
                       builder: str = "auto",
                       tri_refl=None, tri_color=None,
                       tri_uv=None, tri_tex=None, textures=None,
                       tri_vn=None, envmap=None, tri_rough=None,
                       tri_ntex=None, tri_rtex=None, tri_blend=None,
                       tri_metal=None, tri_ior=None, texture_wraps=None,
                       delta_lights: Optional[DeltaLights] = None) -> "Scene":
        """Build from triangle vertices [T, 3] each, with optional
        per-triangle materials (default: white diffuse), roughness, IOR,
        corner normals [T, 3, 3] and the texture records of the loaders.
        ``envmap`` is an [H, W, 3] array or an image path (a JSON
        description with meshes passes its envmap's path here)."""
        spheres = spheres or Spheres.default_seven()
        if isinstance(envmap, str):
            from .texture import load_texture
            envmap = load_texture(envmap)
        v0 = np.asarray(v0, np.float32)
        v1 = np.asarray(v1, np.float32)
        v2 = np.asarray(v2, np.float32)
        tri_lo = np.minimum(np.minimum(v0, v1), v2)
        tri_hi = np.maximum(np.maximum(v0, v1), v2)
        bvh = _build(tri_lo, tri_hi, bvh_cfg, builder)
        stats = bvh_stats(bvh)
        stats["triangles"] = int(v0.shape[0])

        def arr(a, dtype):
            return None if a is None else np.asarray(a, dtype)
        return cls(spheres, v0, v1 - v0, v2 - v0, bvh, stats,
                   tri_refl=arr(tri_refl, np.int32),
                   tri_color=arr(tri_color, np.float32),
                   tri_uv=arr(tri_uv, np.float32),
                   tri_tex=arr(tri_tex, np.int32), textures=textures,
                   tri_vn=arr(tri_vn, np.float32), envmap=envmap,
                   tri_rough=arr(tri_rough, np.float32),
                   tri_blend=arr(tri_blend, bool),
                   tri_metal=arr(tri_metal, bool),
                   tri_ior=arr(tri_ior, np.float32),
                   texture_wraps=texture_wraps,
                   tri_ntex=arr(tri_ntex, np.int32),
                   tri_rtex=arr(tri_rtex, np.int32),
                   delta_lights=delta_lights)

    @classmethod
    def from_instances(cls, meshes, instances,
                       spheres: Optional[Spheres] = None,
                       bvh_cfg: BVHConfig = BVHConfig(),
                       builder: str = "auto", envmap=None,
                       delta_lights: Optional[DeltaLights] = None) -> "Scene":
        """Instanced scene: ``meshes`` are ``instancing.MeshAsset`` (or
        paths, loaded with ``MeshAsset.load``), ``instances`` a list of
        ``(mesh_id, transform)`` with a [4,4] or [3,4] affine transform.
        Instances are flattened into world space and one BVH is built
        over the union."""
        from .instancing import MeshAsset, flatten_instances
        meshes = [MeshAsset.load(m) if isinstance(m, str) else m
                  for m in meshes]
        flat = flatten_instances(meshes, instances)
        s = cls.from_triangles(
            flat.v0, flat.v1, flat.v2, spheres=spheres, bvh_cfg=bvh_cfg,
            builder=builder, tri_refl=flat.tri_refl,
            tri_color=flat.tri_color, tri_uv=flat.tri_uv,
            tri_tex=flat.tri_tex, textures=flat.textures,
            tri_vn=flat.tri_vn, envmap=envmap, tri_rough=flat.tri_rough,
            tri_ntex=flat.tri_ntex, tri_rtex=flat.tri_rtex,
            tri_blend=flat.tri_blend, tri_metal=flat.tri_metal,
            tri_ior=flat.tri_ior, texture_wraps=flat.tex_wraps,
            delta_lights=delta_lights)
        s.stats["instances"] = len(instances)
        s.stats["unique_meshes"] = len(meshes)
        return s

    def to_device(self, device) -> SceneData:
        """Upload the tables to ``device``."""
        if self.bvh is None:
            # spheres-only: single degenerate leaf, so traversal is a no-op
            meta = pack_meta(np.zeros(1, np.int64), np.ones(1, np.int64),
                             np.zeros(1, np.int64))
            node = np.zeros((1, 8), np.float32)
            node[:, 0:3] = 1e10   # inverted bounds -> slab test always fails
            node[:, 3:6] = -1e10
            node[:, 6] = meta.view(np.float32)
            node[:, 7] = np.full(1, -1, np.int32).view(np.float32)
            bvh_dev = BVHDevice.from_numpy(
                node, np.full((8,), -1, np.int32),
                np.zeros((4, 12), np.float32),
                np.zeros((1, 9 * LEAF_WIDTH), np.float32), device)
            tri_refl = np.zeros(4, np.int32)
            tri_color = np.ones((4, 3), np.float32)
            tri_rough = np.full(4, 0.3, np.float32)
        else:
            bvh_dev = BVHDevice.from_host(self.bvh, self.tri_vert,
                                          self.tri_e1, self.tri_e2, device)
            t = self.tri_vert.shape[0]
            perm = self.bvh.perm
            refl = (np.zeros(t, np.int32) if self.tri_refl is None
                    else self.tri_refl)[perm]
            color = (np.ones((t, 3), np.float32) if self.tri_color is None
                     else self.tri_color)[perm]
            rough = (np.full(t, 0.3, np.float32) if self.tri_rough is None
                     else np.asarray(self.tri_rough, np.float32))[perm]
            pad = bvh_dev.tri_packed.shape[0] - t
            tri_refl = np.concatenate([refl, np.zeros(pad, np.int32)])
            tri_color = np.concatenate([color, np.ones((pad, 3), np.float32)])
            tri_rough = np.concatenate([rough, np.full(pad, 0.3, np.float32)])

        tp = bvh_dev.tri_packed.cpu().numpy()
        cross = np.cross(tp[:, 3:6], tp[:, 6:9])
        norm = np.linalg.norm(cross, axis=1, keepdims=True)
        normal = np.where(norm > 0, cross / np.maximum(norm, 1e-30),
                          np.asarray([0.0, 0.0, 1.0], np.float32))
        tri_shade = np.zeros((tp.shape[0], 8), np.float32)
        tri_shade[:, 0:3] = normal
        tri_shade[:, 3] = tri_refl.astype(np.float32)
        tri_shade[:, 4:7] = tri_color
        # GGX perceptual roughness, clamped: alpha -> 0 degenerates D(h)
        tri_shade[:, 7] = np.clip(tri_rough, 0.03, 1.0)
        # LIGHT triangles reuse lane 7 for their surface area (the MIS
        # emitter-hit pdf reads it; a triangle is never both LIGHT and GGX)
        is_lt = tri_refl == LIGHT
        if is_lt.any():
            tri_shade[is_lt, 7] = 0.5 * norm[is_lt, 0]
        # REFR triangles reuse lane 7 for their glass IOR
        has_var_ior = False
        if self.tri_ior is not None and self.bvh is not None:
            ior_p = np.full(tp.shape[0], 1.2, np.float32)
            ti = np.asarray(self.tri_ior, np.float32)[self.bvh.perm]
            ior_p[:ti.shape[0]] = ti
            is_rf = tri_refl == REFR
            tri_shade[is_rf, 7] = ior_p[is_rf]
            has_var_ior = bool((is_rf & (np.abs(ior_p - 1.2) > 1e-6)).any())

        # the texture gates, once, on the host
        has_atlas = (self.textures is not None and len(self.textures) > 0
                     and self.tri_uv is not None and self.bvh is not None)

        def used(ids):
            return bool(has_atlas and ids is not None
                        and (np.asarray(ids) >= 0).any())
        has_tex, has_nmap = used(self.tri_tex), used(self.tri_ntex)
        has_rmap = used(self.tri_rtex)
        has_smooth = self.tri_vn is not None and self.bvh is not None
        has_alpha = bool(has_tex and any(
            im.shape[2] >= 4 and (np.asarray(im[:, :, 3]) < 1.0).any()
            for im in self.textures))
        # the refl-lane flags, written only under their gates: a blend flag
        # needs the alpha taps, a metal flag the rough-map taps and a GGX
        # triangle (dropped per triangle elsewhere)
        blend = self._leaf_mask(self.tri_blend, tp.shape[0])
        has_blend = bool(has_alpha and blend.any())
        if has_blend:
            tri_shade[:, 3] += 16.0 * blend
        metal = self._leaf_mask(self.tri_metal, tp.shape[0]) \
            & (tri_refl == GGX)
        has_metal = bool(has_rmap and metal.any())
        if has_metal:
            tri_shade[:, 3] += 32.0 * metal
        tex = dict(tex_data=None, tex_meta=())
        if has_tex or has_smooth or has_nmap or has_rmap:
            tri_attr, tex = self._attr_rows(tp.shape[0], has_tex, has_nmap,
                                            has_rmap, has_smooth)
        else:
            tri_attr = np.zeros((4, 32), np.float32)

        s = self.spheres
        sphere_table = np.zeros((s.count, 12), np.float32)
        sphere_table[:, 0:3] = s.center
        sphere_table[:, 3] = s.radius
        sphere_table[:, 4:7] = s.color
        sphere_table[:, 7:10] = s.emission
        sphere_table[:, 10] = s.refl.astype(np.float32)
        sphere_table[:, 11] = np.clip(
            np.full(s.count, 0.3, np.float32) if s.roughness is None
            else np.asarray(s.roughness, np.float32), 0.03, 1.0)
        if s.count == 0:
            # zero-sphere scene: one inert row, so the shade fetch's
            # clamped index stays in range (radius 1 avoids a masked /0)
            sphere_table = np.zeros((1, 12), np.float32)
            sphere_table[0, 3] = 1.0
            sphere_table[0, 11] = 0.3
        return scene_data(
            bvh_dev, tri_shade, sphere_table, device, n_spheres=s.count,
            tri_attr=tri_attr, smooth_normals=has_smooth,
            **self._light_tables(),
            has_ggx=bool((s.refl == GGX).any() or (tri_refl == GGX).any()),
            has_rrefr=bool((s.refl == RREFR).any()
                           or (tri_refl == RREFR).any()),
            has_var_ior=has_var_ior,
            tri_default_mat=(self.tri_refl is None and self.tri_color is None
                             and not has_tex and not has_smooth
                             and not has_nmap and not has_rmap),
            **tex, has_albedo_tex=has_tex, has_normal_maps=has_nmap,
            has_rough_maps=has_rmap, has_alpha_tex=has_alpha,
            has_blend=has_blend, has_metal_maps=has_metal)

    def _leaf_mask(self, mask, rows: int) -> np.ndarray:
        """A per-triangle bool record [T] in leaf order, padded with False
        to ``rows``."""
        out = np.zeros(rows, bool)
        if mask is not None and self.bvh is not None \
                and np.asarray(mask).any():
            m = np.asarray(mask, bool)[self.bvh.perm]
            out[:m.shape[0]] = m
        return out

    def _light_tables(self) -> dict:
        """The light tables of :class:`SceneData` as numpy, in the JAX
        packer's order and float32 arithmetic (tyrant_tpu/scene/scene.py
        to_device): tri_lights, env_data/env_alias/env_meta,
        delta_lights, light_powers in the pick order and, beyond 64
        lights, light_alias; the counts beside them."""
        out = {}
        n_tri_lights = 0
        if self.tri_refl is not None and self.bvh is not None \
                and (np.asarray(self.tri_refl) == LIGHT).any():
            lm = np.asarray(self.tri_refl) == LIGHT
            lv0, le1, le2 = self.tri_vert[lm], self.tri_e1[lm], self.tri_e2[lm]
            lem = (np.ones((lm.sum(), 3), np.float32)
                   if self.tri_color is None else
                   np.asarray(self.tri_color, np.float32)[lm])
            if self.textures is not None and self.tri_tex is not None:
                # texture-modulated emitters: NEE and the power table use
                # the texture's mean (direct hits show the texel)
                tt = np.asarray(self.tri_tex)[lm]
                means = np.asarray(
                    [t[:, :, :3].reshape(-1, 3).mean(0)
                     for t in self.textures], np.float32)
                lem = lem * np.where((tt >= 0)[:, None],
                                     means[np.clip(tt, 0, len(means) - 1)],
                                     1.0)
            larea = 0.5 * np.linalg.norm(np.cross(le1, le2), axis=1)
            tl = np.concatenate([lv0, le1, le2, lem, larea[:, None]],
                                axis=1).astype(np.float32)
            n_tri_lights = int(lm.sum())
            out["tri_lights"] = tl
        out["n_tri_lights"] = n_tri_lights

        if self.envmap is not None:
            em = np.asarray(self.envmap, np.float32)
            eh, ew = em.shape[0], em.shape[1]
            env_rows = np.ones((eh * ew + 1, 4), np.float32)
            env_rows[1:, :3] = em[:, :, :3].reshape(eh * ew, 3)
            pdf_sa, alias_rows = env_tables(em)
            env_rows[0, 3] = 0.0
            env_rows[1:, 3] = pdf_sa
            out.update(env_data=env_rows, env_alias=alias_rows,
                       env_meta=(float(eh), float(ew)))

        n_delta = 0
        if self.delta_lights is not None and self.delta_lights.count:
            out["delta_lights"] = self.delta_lights.pack()
            n_delta = self.delta_lights.count
        out["n_delta_lights"] = n_delta

        # per-light powers in the pick order, all terms in float32 so the
        # emitter-hit pdf, recomputed from the device rows, matches;
        # delta lights weigh by a solid angle (point 4 pi, spot its cone,
        # directional 1): any positive weight keeps the estimator unbiased
        powers = []
        for li in np.nonzero(self.spheres.refl == LIGHT)[0]:
            em32 = np.asarray(self.spheres.emission[li], np.float32)
            r32 = np.float32(self.spheres.radius[li])
            powers.append(float(np.float32(em32 @ LUM_RGB)
                                * np.float32(4.0 * np.pi) * r32 * r32))
        for k in range(n_tri_lights):
            tl32 = out["tri_lights"]
            powers.append(float(np.float32(tl32[k, 9:12] @ LUM_RGB)
                                * tl32[k, 12]))
        if n_delta:
            dl = out["delta_lights"]
            for k in range(n_delta):
                lum = float(dl[k, 7:10] @ LUM_RGB)
                kind = dl[k, 0]
                if kind == 0.0:                    # point
                    sa = 4.0 * np.pi
                elif kind == 1.0:                  # spot: cone solid angle
                    sa = 2.0 * np.pi * (1.0 - 0.5 * (dl[k, 10] + dl[k, 11]))
                else:                              # directional
                    sa = 1.0
                powers.append(lum * sa)
        out["light_powers"] = np.asarray(powers if powers else [0.0],
                                         np.float32)
        if len(powers) > 64:
            # one Vose alias row [keep, alias, 1/pdf(self), 1/pdf(alias)]
            # a light, under the 0.75 power + 0.25 uniform mixture that
            # the CDF pick and the MIS hit side use too
            n_l = len(powers)
            total_p = float(np.sum(np.asarray(powers, np.float64)))
            if total_p > 0.0:
                pm = (0.75 * np.asarray(powers, np.float64) / total_p
                      + 0.25 / n_l)
            else:
                pm = np.full(n_l, 1.0 / n_l)
            prob, alias = build_alias(pm)
            inv = np.where(pm > 0, 1.0 / np.maximum(pm, 1e-300), 0.0)
            la = np.zeros((n_l, 4), np.float32)
            la[:, 0] = prob
            la[:, 1] = alias
            la[:, 2] = inv
            la[:, 3] = inv[alias]
            out["light_alias"] = la
        return out

    def _attr_rows(self, rows: int, has_tex: bool, has_nmap: bool,
                   has_rmap: bool, has_smooth: bool):
        """tri_attr [rows, 32] in leaf order (the dual basis of the edges,
        and under their gates the uv lanes, the map ids, the uv tangent
        with its handedness and the corner normals), and the texture
        atlas {tex_data, tex_meta} when a map is used, as the JAX packer
        fills them (tyrant_tpu/scene/scene.py to_device)."""
        perm = self.bvh.perm
        e1 = self.tri_e1[perm].astype(np.float64)
        e2 = self.tri_e2[perm].astype(np.float64)
        d11 = np.sum(e1 * e1, axis=1)
        d22 = np.sum(e2 * e2, axis=1)
        d12 = np.sum(e1 * e2, axis=1)
        det = np.maximum(d11 * d22 - d12 * d12, 1e-30)
        s1 = (d22[:, None] * e1 - d12[:, None] * e2) / det[:, None]
        s2 = (d11[:, None] * e2 - d12[:, None] * e1) / det[:, None]
        t = self.tri_vert.shape[0]
        attr = np.zeros((rows, 32), np.float32)
        attr[:t, 0:3] = self.tri_vert[perm]
        attr[:t, 3:6] = s1
        attr[:t, 6:9] = s2
        attr[:, 15] = -1.0
        attr[:, 26] = -1.0
        attr[:, 31] = -1.0
        tex = dict(tex_data=None, tex_meta=())
        if has_tex or has_nmap or has_rmap:
            from .texture import TextureAtlas
            # mips=True: the pyramids ride after every base image, so the
            # base offsets are those of a pack without mips
            atlas = TextureAtlas.pack(self.textures, mips=True)
            uv = np.asarray(self.tri_uv, np.float32)[perm]  # [T, 3, 2]
            attr[:t, 9:11] = uv[:, 0]
            attr[:t, 11:13] = uv[:, 1] - uv[:, 0]
            attr[:t, 13:15] = uv[:, 2] - uv[:, 0]
            if has_tex:
                attr[:t, 15] = np.asarray(self.tri_tex, np.int32)[perm]
            wraps = (self.texture_wraps if self.texture_wraps is not None
                     else [(0, 0)] * len(atlas.meta))
            tex = dict(tex_data=atlas.data, tex_meta=tuple(
                (int(o), int(h), int(w), int(wraps[k][0]), int(wraps[k][1]),
                 tuple((int(mo), int(mh), int(mw))
                       for (mo, mh, mw) in atlas.mip_meta[k]))
                for k, (o, h, w) in enumerate(atlas.meta)))
        if has_nmap:
            # the uv tangent T = (dv2 e1 - dv1 e2) / det and the
            # bitangent's handedness; a degenerate uv map disables the map
            du1 = (uv[:, 1] - uv[:, 0]).astype(np.float64)
            du2 = (uv[:, 2] - uv[:, 0]).astype(np.float64)
            det_uv = du1[:, 0] * du2[:, 1] - du2[:, 0] * du1[:, 1]
            ok_uv = np.abs(det_uv) > 1e-12
            inv = 1.0 / np.where(ok_uv, det_uv, 1.0)
            tang = (du2[:, 1:2] * e1 - du1[:, 1:2] * e2) * inv[:, None]
            bitan = (du1[:, 0:1] * e2 - du2[:, 0:1] * e1) * inv[:, None]
            tlen = np.linalg.norm(tang, axis=1)
            ok_uv &= tlen > 1e-12
            tang = tang / np.maximum(tlen, 1e-30)[:, None]
            geo_n = np.cross(e1, e2)
            handed = np.where(
                np.sum(np.cross(geo_n, tang) * bitan, axis=1) >= 0.0,
                1.0, -1.0)
            ntex = np.asarray(self.tri_ntex, np.int32)[perm]
            attr[:t, 26] = np.where(ok_uv, ntex, -1)
            attr[:t, 27:30] = tang.astype(np.float32)
            attr[:t, 30] = handed.astype(np.float32)
        if has_rmap:
            attr[:t, 31] = np.asarray(self.tri_rtex, np.int32)[perm]
        if has_smooth:
            vn = np.asarray(self.tri_vn, np.float32)[perm]  # [T, 3, 3]
            ok = (np.linalg.norm(vn, axis=2) > 1e-8).all(axis=1)
            attr[:t, 16:19] = vn[:, 0]
            attr[:t, 19:22] = vn[:, 1] - vn[:, 0]
            attr[:t, 22:25] = vn[:, 2] - vn[:, 0]
            attr[:t, 25] = ok.astype(np.float32)
        return attr, tex


def scene_data(bvh: BVHDevice, tri_shade, sphere_table, device, *,
               n_spheres: int, tri_attr=None, smooth_normals: bool = False,
               has_ggx: bool = False, has_rrefr: bool = False,
               has_var_ior: bool = False, tri_default_mat: bool = False,
               tri_lights=None, n_tri_lights: int = 0, delta_lights=None,
               n_delta_lights: int = 0, light_powers=None, light_alias=None,
               env_data=None, env_alias=None,
               env_meta: tuple = (), tex_data=None, tex_meta: tuple = (),
               has_albedo_tex: bool = False, has_normal_maps: bool = False,
               has_rough_maps: bool = False, has_alpha_tex: bool = False,
               has_blend: bool = False,
               has_metal_maps: bool = False) -> SceneData:
    """SceneData from the numpy shade, texture and light tables (shared by
    Scene.to_device and interop); an absent light or texel table gets the
    JAX package's inert one-row stand-in.  The sphere columns are the first
    ``n_spheres`` rows of sphere_table (a zero-sphere scene keeps one
    inert row there).  The power pick's CDF, inverse pdfs and total are
    derived here from ``light_powers``."""
    def t(a):
        return torch.as_tensor(np.array(a, np.float32), device=device)

    def table(a, shape, fill=0.0):
        return t(np.full(shape, fill, np.float32) if a is None else a)
    st = np.asarray(sphere_table, np.float32)
    live = st[:n_spheres]
    lights = np.nonzero(live[:, 10] == LIGHT)[0]
    if tri_attr is None:
        tri_attr = np.zeros((4, 32), np.float32)
    pw = table(light_powers, (1,)).cpu()
    cdf, inv_pdf, total = _power_pick(pw)
    return SceneData(bvh=bvh, sphere_center=t(live[:, 0:3]),
                     sphere_radius=t(live[:, 3]),
                     sphere_emission=t(live[:, 7:10]),
                     light_index=int(lights[0]) if lights.size else -1,
                     tri_shade=t(tri_shade), sphere_table=t(st),
                     tri_attr=t(tri_attr), smooth_normals=smooth_normals,
                     has_ggx=has_ggx, has_rrefr=has_rrefr,
                     has_var_ior=has_var_ior,
                     tri_default_mat=tri_default_mat,
                     light_indices=tuple(int(i) for i in lights),
                     tri_lights=table(tri_lights, (1, 13)),
                     n_tri_lights=int(n_tri_lights),
                     delta_lights=table(delta_lights, (1, 12)),
                     n_delta_lights=int(n_delta_lights),
                     light_powers=pw.to(device), light_cdf=cdf.to(device),
                     light_inv_pdf=inv_pdf.to(device),
                     light_total_power=total.to(device),
                     light_alias=table(light_alias, (1, 4)),
                     env_data=table(env_data, (1, 4), 1.0),
                     env_alias=table(env_alias, (1, 12)),
                     env_meta=tuple(float(v) for v in env_meta),
                     tex_data=table(tex_data, (1, 4), 1.0),
                     tex_meta=tuple(tex_meta), has_albedo_tex=has_albedo_tex,
                     has_normal_maps=has_normal_maps,
                     has_rough_maps=has_rough_maps,
                     has_alpha_tex=has_alpha_tex, has_blend=has_blend,
                     has_metal_maps=has_metal_maps)


def _power_pick(pw: torch.Tensor):
    """(cdf, 1 / max(pdf, 1e-30), total power) of the power pick over
    the light powers ``pw`` [L] (float32, on the CPU): pdf = 0.75 power /
    total + 0.25 / L, or 1 / L when the total is 0, as the JAX shade
    traces it (tyrant_tpu/render.py:1171-1194).  The pick of a uniform
    lu is the number of CDF entries at or below it among the first
    L - 1."""
    n_l = pw.shape[0]
    total = pw.sum()
    pdfs = torch.where(total > 0,
                       0.75 * pw / torch.clamp(total, min=1e-30) + 0.25 / n_l,
                       torch.full_like(pw, 1.0 / n_l))
    return (torch.cumsum(pdfs, 0), 1.0 / torch.clamp(pdfs, min=1e-30),
            total)


def _override(sc: Scene, spheres, envmap, delta_lights) -> Scene:
    """The caller's spheres, envmap and delta lights replace a composed
    scene's own (glTF and JSON files carry theirs)."""
    if isinstance(envmap, str):
        from .texture import load_texture
        envmap = load_texture(envmap)
    if envmap is not None:
        sc.envmap = envmap
    if spheres is not None:
        sc.spheres = spheres
    if delta_lights is not None:
        sc.delta_lights = delta_lights
    return sc


def _ply_has_attrs(path: str) -> bool:
    """Header sniff: vertex normals OR colors (either routes the load
    through the python attribute loader instead of the native fast path)."""
    try:
        with open(path, "rb") as f:
            head = f.read(4096)
        head = head[:head.find(b"end_header") + 1 or None]
        return b" nx" in head or b" red" in head
    except OSError:
        return False


# what a missing or failing g++ raises (the native library cannot build or
# load); the Python loader and builder then give the same result
_NATIVE_UNAVAILABLE = (OSError, subprocess.CalledProcessError)


def load_mesh(path: str):
    """(vertices [V, 3] f32, faces [F, 3] i32) of a .ply, .obj or .stl
    file.  A PLY goes through the native loader when it builds; a file
    the native loader rejects raises its ValueError."""
    if path.endswith(".ply"):
        try:
            from ..native import ply_native
            return ply_native.load_ply(path)
        except _NATIVE_UNAVAILABLE:
            return ply.load_ply(path)
    if path.endswith(".obj"):
        from .obj import load_obj
        return load_obj(path)
    if path.endswith(".stl"):
        from .stl import load_stl
        return load_stl(path)
    raise ValueError(f"unsupported mesh format: {path}")


def _build(tri_lo, tri_hi, cfg: BVHConfig, builder: str) -> BVHArrays:
    if builder in ("auto", "native"):
        try:
            from ..native import bvh_native
            return bvh_native.build_bvh(tri_lo, tri_hi, cfg)
        except (RuntimeError, *_NATIVE_UNAVAILABLE):
            # no compiler or loader for the native builder: numpy builds
            # the same tree
            if builder == "native":
                raise
    return build_bvh(tri_lo, tri_hi, cfg)
