"""Scene container, the port of ``tyrant_tpu/scene/scene.py`` for the
main path: analytic spheres plus one triangle mesh with optional
per-triangle DIFF/SPEC/REFR/PHONG materials, at most one emissive sphere.

Host packing is the JAX package's numpy code, so every table equals the
JAX one bit for bit.  Scene features the port does not implement yet
(textures, smooth normals, environment maps, delta or triangle lights,
GGX and rough glass, per-triangle IOR, several emissive spheres) raise
ValueError instead of rendering something else.
"""

from __future__ import annotations

import dataclasses
import subprocess
from typing import Optional

import numpy as np
import torch

from ..config import BVHConfig
from ..ops.traverse import LEAF_WIDTH, BVHDevice
from .bvh import BVHArrays, build_bvh, bvh_stats, pack_meta

DIFF, SPEC, REFR, PHONG, LIGHT = 0, 1, 2, 3, 4
PORTED_MATERIALS = (DIFF, SPEC, REFR, PHONG, LIGHT)


@dataclasses.dataclass
class Spheres:
    """Host-side analytic sphere list."""

    center: np.ndarray    # [S, 3] f32
    radius: np.ndarray    # [S] f32
    color: np.ndarray     # [S, 3] f32
    emission: np.ndarray  # [S, 3] f32
    refl: np.ndarray      # [S] i32

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


@dataclasses.dataclass
class SceneData:
    """Device-resident scene tables read by the render step.

    tri_shade [T+pad, 8]: geometric normal.xyz, refl, color.rgb, roughness
    sphere_table [S, 12]: center.xyz, radius, color.rgb, emission.rgb,
        refl, roughness
    """

    bvh: BVHDevice
    sphere_center: torch.Tensor    # [S, 3]
    sphere_radius: torch.Tensor    # [S]
    sphere_emission: torch.Tensor  # [S, 3]
    light_index: int               # the one emissive sphere, or -1
    tri_shade: torch.Tensor        # [T+pad, 8] (leaf order)
    sphere_table: torch.Tensor     # [S, 12]


def _spheres_ok(s: Spheres) -> None:
    if s.count == 0:
        raise ValueError("a scene without spheres is not ported")
    bad = sorted(set(int(r) for r in s.refl) - set(PORTED_MATERIALS))
    if bad:
        raise ValueError(f"sphere materials {bad} (GGX/RREFR) are not ported")
    if int((s.refl == LIGHT).sum()) > 1:
        raise ValueError("several emissive spheres: multi-light NEE is not "
                         "ported")


@dataclasses.dataclass
class Scene:
    """Host-side scene: build and upload."""

    spheres: Spheres
    tri_vert: np.ndarray  # [T, 3] (original order)
    tri_e1: np.ndarray
    tri_e2: np.ndarray
    bvh: Optional[BVHArrays]
    stats: dict
    tri_refl: Optional[np.ndarray] = None   # [T] i32, default DIFF
    tri_color: Optional[np.ndarray] = None  # [T, 3] f32, default white

    @classmethod
    def load(cls, path: Optional[str] = None,
             spheres: Optional[Spheres] = None, **unported) -> "Scene":
        """``path=None``: a spheres-only scene.  Mesh files, environment
        maps and delta lights are not ported."""
        if path is not None:
            raise ValueError("Scene.load: mesh files are not ported; build "
                             "the mesh with Scene.from_triangles")
        _refuse(unported)
        spheres = spheres or Spheres.default_seven()
        _spheres_ok(spheres)
        z = np.zeros((0, 3), np.float32)
        return cls(spheres, z, z, z, None, {"nodes": 0})

    @classmethod
    def from_triangles(cls, v0, v1, v2, spheres: Optional[Spheres] = None,
                       bvh_cfg: BVHConfig = BVHConfig(),
                       builder: str = "auto", tri_refl=None, tri_color=None,
                       **unported) -> "Scene":
        """Build from triangle vertices [T, 3] each.  tri_refl [T]
        (DIFF/SPEC/REFR/PHONG) and tri_color [T, 3] are optional
        per-triangle materials (default: white diffuse)."""
        _refuse(unported)
        spheres = spheres or Spheres.default_seven()
        _spheres_ok(spheres)
        if tri_refl is not None:
            tri_refl = np.asarray(tri_refl, np.int32)
            bad = sorted(set(np.unique(tri_refl).tolist())
                         - {DIFF, SPEC, REFR, PHONG})
            if bad:
                raise ValueError(f"triangle materials {bad} (emissive "
                                 "triangles, GGX, RREFR) are not ported")
        v0 = np.asarray(v0, np.float32)
        v1 = np.asarray(v1, np.float32)
        v2 = np.asarray(v2, np.float32)
        tri_lo = np.minimum(np.minimum(v0, v1), v2)
        tri_hi = np.maximum(np.maximum(v0, v1), v2)
        bvh = _build(tri_lo, tri_hi, bvh_cfg, builder)
        stats = bvh_stats(bvh)
        stats["triangles"] = int(v0.shape[0])
        return cls(spheres, v0, v1 - v0, v2 - v0, bvh, stats,
                   tri_refl=tri_refl,
                   tri_color=None if tri_color is None
                   else np.asarray(tri_color, np.float32))

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
        else:
            bvh_dev = BVHDevice.from_host(self.bvh, self.tri_vert,
                                          self.tri_e1, self.tri_e2, device)
            t = self.tri_vert.shape[0]
            perm = self.bvh.perm
            refl = (np.zeros(t, np.int32) if self.tri_refl is None
                    else self.tri_refl)[perm]
            color = (np.ones((t, 3), np.float32) if self.tri_color is None
                     else self.tri_color)[perm]
            pad = bvh_dev.tri_packed.shape[0] - t
            tri_refl = np.concatenate([refl, np.zeros(pad, np.int32)])
            tri_color = np.concatenate([color, np.ones((pad, 3), np.float32)])

        tp = bvh_dev.tri_packed.cpu().numpy()
        cross = np.cross(tp[:, 3:6], tp[:, 6:9])
        norm = np.linalg.norm(cross, axis=1, keepdims=True)
        normal = np.where(norm > 0, cross / np.maximum(norm, 1e-30),
                          np.asarray([0.0, 0.0, 1.0], np.float32))
        tri_shade = np.zeros((tp.shape[0], 8), np.float32)
        tri_shade[:, 0:3] = normal
        tri_shade[:, 3] = tri_refl.astype(np.float32)
        tri_shade[:, 4:7] = tri_color
        tri_shade[:, 7] = 0.3  # GGX roughness lane, unread by ported BSDFs

        s = self.spheres
        sphere_table = np.zeros((s.count, 12), np.float32)
        sphere_table[:, 0:3] = s.center
        sphere_table[:, 3] = s.radius
        sphere_table[:, 4:7] = s.color
        sphere_table[:, 7:10] = s.emission
        sphere_table[:, 10] = s.refl.astype(np.float32)
        sphere_table[:, 11] = 0.3  # GGX roughness lane, as for triangles
        return scene_data(bvh_dev, tri_shade, sphere_table, device)


def scene_data(bvh: BVHDevice, tri_shade, sphere_table,
               device) -> SceneData:
    """SceneData from the numpy shade tables (shared by Scene.to_device and
    interop); the sphere columns are views of sphere_table."""
    def t(a):
        return torch.as_tensor(np.array(a, np.float32), device=device)
    st = np.asarray(sphere_table, np.float32)
    lights = np.nonzero(st[:, 10] == LIGHT)[0]
    return SceneData(bvh=bvh, sphere_center=t(st[:, 0:3]),
                     sphere_radius=t(st[:, 3]), sphere_emission=t(st[:, 7:10]),
                     light_index=int(lights[0]) if lights.size else -1,
                     tri_shade=t(tri_shade), sphere_table=t(st))


def _refuse(unported: dict) -> None:
    given = sorted(k for k, v in unported.items() if v is not None)
    if given:
        raise ValueError(f"scene features not ported: {', '.join(given)}")


def _build(tri_lo, tri_hi, cfg: BVHConfig, builder: str) -> BVHArrays:
    if builder in ("auto", "native"):
        try:
            from ..native import bvh_native
            return bvh_native.build_bvh(tri_lo, tri_hi, cfg)
        except (OSError, RuntimeError, subprocess.CalledProcessError):
            # no compiler or loader for the native builder: numpy builds
            # the same tree
            if builder == "native":
                raise
    return build_bvh(tri_lo, tri_hi, cfg)
