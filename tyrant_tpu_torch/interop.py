"""Carry the JAX package's arrays, given as numpy, into the port's objects.

The tests feed one captured JAX scene, state and camera to both packages
through these functions, so the two run on identical inputs.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from .camera import CameraParams
from .ops.kernels.traverse import PacketTables
from .ops.traverse import BVHDevice
from .render import RenderState
from .scene.scene import SceneData, scene_data

SCENE_LEAVES = ("node_packed", "miss_flat", "tri_packed", "leaf_packed",
                "tri_shade", "sphere_table", "tri_attr", "sphere_center",
                "tri_lights", "delta_lights", "light_powers", "light_alias",
                "env_data", "env_alias", "tex_data")
# the SceneData flags the render step gates its terms on
SCENE_FLAGS = ("smooth_normals", "has_ggx", "has_rrefr", "has_var_ior",
               "tri_default_mat", "has_albedo_tex", "has_normal_maps",
               "has_rough_maps", "has_alpha_tex", "has_blend",
               "has_metal_maps")
# the SceneData counts and sizes the render step reads on the host (the
# texture meta is a static tuple of Python ints)
SCENE_AUX = ("n_tri_lights", "n_delta_lights", "env_meta", "tex_meta")
STATE_FIELDS = ("accum", "origin", "direction", "direct", "pending", "pixel",
                "bounces", "last_specular", "n_carried", "start_position",
                "frame", "shadow_rays", "bsdf_pdf", "moment2", "pixel_perm",
                "sample_base", "sample_idx")
# the port's dtype of each RenderState field that is not float32: the JAX
# package's uint32 counters and Sobol indices are int64 here
STATE_DTYPES = dict(pixel=torch.int32, bounces=torch.int32,
                    last_specular=torch.bool, n_carried=torch.int64,
                    start_position=torch.int64, frame=torch.int64,
                    shadow_rays=torch.int64, pixel_perm=torch.int32,
                    sample_base=torch.int64, sample_idx=torch.int64)


def scene_from_numpy(leaves: Mapping[str, np.ndarray], rows: np.ndarray,
                     device, flags: Mapping[str, bool] | None = None,
                     aux: Mapping | None = None
                     ) -> tuple[SceneData, PacketTables]:
    """``leaves``: the SceneData arrays named in SCENE_LEAVES (the BVH's
    four under their BVHDevice names; ``sphere_center`` [S, 3] gives the
    sphere count, 0 for a scene without spheres); ``rows``:
    PacketTables.rows; ``flags``: the SceneData flags named in
    SCENE_FLAGS (absent ones are off); ``aux``: the counts named in
    SCENE_AUX (absent ones are 0, or () for env_meta and tex_meta)."""
    missing = [k for k in SCENE_LEAVES if k not in leaves]
    if missing:
        raise ValueError(f"scene leaves missing: {missing}")
    flags = dict(flags or {})
    unknown = set(flags) - set(SCENE_FLAGS)
    if unknown:
        raise ValueError(f"unknown scene flags: {sorted(unknown)}")
    aux = dict(aux or {})
    unknown = set(aux) - set(SCENE_AUX)
    if unknown:
        raise ValueError(f"unknown scene aux fields: {sorted(unknown)}")
    bvh = BVHDevice.from_numpy(leaves["node_packed"], leaves["miss_flat"],
                               leaves["tri_packed"], leaves["leaf_packed"],
                               device)
    sd = scene_data(bvh, leaves["tri_shade"], leaves["sphere_table"], device,
                    n_spheres=int(np.shape(leaves["sphere_center"])[0]),
                    tri_attr=leaves["tri_attr"],
                    **{k: leaves[k] for k in SCENE_LEAVES[8:]},
                    n_tri_lights=int(aux.get("n_tri_lights", 0)),
                    n_delta_lights=int(aux.get("n_delta_lights", 0)),
                    env_meta=tuple(aux.get("env_meta", ())),
                    tex_meta=tuple(aux.get("tex_meta", ())),
                    **{k: bool(v) for k, v in flags.items()})
    return sd, PacketTables(bvh, rows=np.asarray(rows))


def state_from_numpy(fields: Mapping[str, np.ndarray], device) -> RenderState:
    """``fields``: the RenderState fields named in STATE_FIELDS, in the JAX
    package's dtypes or the port's."""
    def tensor(k):
        a = np.array(fields[k])
        if a.dtype == np.uint32:  # torch's uint32 lacks most ops
            a = a.astype(np.int64)
        return torch.as_tensor(a, device=device).to(
            STATE_DTYPES.get(k, torch.float32))
    return RenderState(**{k: tensor(k) for k in STATE_FIELDS})


def camera_from_numpy(position, direction, right, up, focal_distance,
                      lens_radius, device) -> CameraParams:
    def t(a):
        return torch.as_tensor(np.array(a, np.float32), device=device)
    return CameraParams(position=t(position), direction=t(direction),
                        right=t(right), up=t(up),
                        focal_distance=t(focal_distance),
                        lens_radius=t(lens_radius))
