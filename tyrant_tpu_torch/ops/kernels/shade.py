"""The shade stage of the render step in one launch of the CUDA kernel
``csrc/shade.cu``, on the base feature set that ``render._fused_shade``
admits: the sphere materials DIFF, SPEC, REFR, PHONG and LIGHT, triangles
from their tri_shade rows or (``tri_normal``, a ``tri_default_mat`` scene)
from the traversal's hit normals, at most one emissive sphere plus the sun
and the analytic sky, the xorshift streams, no MIS.  Its plain version is
``render._shade_plain``, which every other configuration and every CPU
tensor takes.

The kernel writes the tensors the plain body returns, with their dtypes
and layouts (bool as bytes), and launches on the current stream without a
host synchronise or an allocation of its own, so a CUDA graph can capture
it.  The outputs equal the plain body's on the CUDA device on every slot
the step reads: colour, survive and the next ray on every slot, the shadow
ray where it is valid; an invalid shadow ray's colour is 0.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ...config import VERY_FAR, SkyConfig
from ...sky import RAYLEIGH_AT_X
from . import build

# kernel launches since the last reset
launches = 0

_INTS = ("n", "max_bounces", "row_offset", "light", "has_light",
         "n_tri_rows", "n_sphere_rows")
_FLOATS = ("eps", "neg2eps", "very_far", "sun_extent", "cos_sun",
           "sun_intensity", "cutoff", "inv_steep", "rzl", "mzl", "ray0",
           "ray1", "ray2", "g2x", "gg", "one_m_gg", "sky_k", "inv_disc")


class _Consts(ctypes.Structure):
    """shade.cu's ShadeConsts, field for field."""

    _fields_ = [(k, ctypes.c_int) for k in _INTS] \
        + [(k, ctypes.c_float) for k in _FLOATS]


@functools.lru_cache(maxsize=None)
def _sky_consts(sky: SkyConfig, cos_sun: float) -> dict:
    """The sky's scalars as the plain body's float32 ops see them: a
    Python scalar rounded to float32, a division by one a multiply by its
    float32 reciprocal."""
    f32 = np.float32
    g = sky.mie_directional_g
    out = dict(sun_extent=f32(1.0 - cos_sun), cos_sun=f32(cos_sun),
               sun_intensity=f32(sky.sun_intensity),
               cutoff=f32(sky.cutoff_angle),
               inv_steep=f32(1.0) / f32(sky.steepness),
               rzl=f32(sky.rayleigh_zenith_length),
               mzl=f32(sky.mie_zenith_length), g2x=f32(2.0 * g),
               gg=f32(g * g), one_m_gg=f32(1.0 - g * g),
               sky_k=f32(sky.sky_factor * 0.01),
               inv_disc=f32(1.0) / f32(0.00002))
    out.update((f"ray{k}", f32(v)) for k, v in enumerate(RAYLEIGH_AT_X))
    return {k: float(v) for k, v in out.items()}


def _consts(cfg, scene, sky_params, row_offset: int) -> _Consts:
    c = _Consts(n=cfg.num_rays, max_bounces=cfg.max_bounces,
                row_offset=row_offset, light=max(scene.light_index, 0),
                has_light=int(scene.light_index >= 0),
                n_tri_rows=scene.tri_shade.shape[0],
                n_sphere_rows=scene.sphere_table.shape[0],
                eps=float(np.float32(cfg.epsilon)),
                neg2eps=float(np.float32(-2.0 * cfg.epsilon)),
                very_far=float(np.float32(VERY_FAR)))
    for k, v in _sky_consts(sky_params.cfg,
                            sky_params.sun_angular_diameter_cos).items():
        setattr(c, k, v)
    return c


def _check(dev, args) -> None:
    for name, x, dtype, shape in args:
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, t on {dev}")
        if x.dtype != dtype or tuple(x.shape) != shape \
                or not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous {dtype} of shape "
                             f"{shape}, got {x.dtype} {tuple(x.shape)}")


def shade(cfg, scene, sky_params, sun_dir, rays, t, ident, is_tri, frame,
          tri_normal=None, row_offset: int = 0):
    """``render._shade`` in one kernel launch, for CUDA tensors: (color,
    survive, next_rays, shadow).  ``tri_normal`` [N, 3]: the traversal's
    hit normals on a ``tri_default_mat`` scene (the kernel's normals
    variant), else None (the tri_shade rows).  ``frame`` is the salted
    frame counter, an int64 tensor on the device (read by the kernel, so a
    captured graph sees each replay's)."""
    global launches
    n, dev = cfg.num_rays, t.device
    if dev.type != "cuda":
        raise ValueError(f"the shade kernel needs CUDA tensors, got {dev}")
    f32, b8, i32 = torch.float32, torch.bool, torch.int32
    ins = [("origin", rays["origin"], f32, (n, 3)),
           ("direction", rays["direction"], f32, (n, 3)),
           ("direct", rays["direct"], f32, (n, 3)),
           ("pixel", rays["pixel"], i32, (n,)),
           ("bounces", rays["bounces"], i32, (n,)),
           ("last_specular", rays["last_specular"], b8, (n,)),
           ("t", t, f32, (n,)), ("ident", ident, i32, (n,)),
           ("is_tri", is_tri, b8, (n,))]
    if tri_normal is not None:
        ins.append(("tri_normal", tri_normal, f32, (n, 3)))
    frame = torch.as_tensor(frame, dtype=torch.int64, device=dev)
    sun = sun_dir.to(dev, f32).contiguous()
    tables = [("tri_shade", scene.tri_shade, f32,
               (scene.tri_shade.shape[0], 8)),
              ("sphere_table", scene.sphere_table, f32,
               (scene.sphere_table.shape[0], 12)),
              ("sun_dir", sun, f32, (3,)),
              ("total_mie", sky_params.total_mie(dev), f32, (3,)),
              ("frame", frame, torch.int64, ())]
    _check(dev, ins + tables)

    def empty(*shape, dtype=f32):
        return torch.empty(shape, dtype=dtype, device=dev)
    color, survive = empty(n, 3), empty(n, dtype=b8)
    next_rays = dict(origin=empty(n, 3), direction=empty(n, 3),
                     direct=empty(n, 3), pixel=rays["pixel"],
                     bounces=empty(n, dtype=i32),
                     last_specular=empty(n, dtype=b8))
    shadow = dict(origin=empty(n, 3), direction=empty(n, 3),
                  color=empty(n, 3), max_dist=empty(n), valid=empty(n,
                                                                    dtype=b8))
    consts = _consts(cfg, scene, sky_params, row_offset)
    outs = [color, survive, next_rays["origin"], next_rays["direction"],
            next_rays["direct"], next_rays["bounces"],
            next_rays["last_specular"], shadow["origin"],
            shadow["direction"], shadow["color"], shadow["max_dist"],
            shadow["valid"]]
    ptrs = [x.data_ptr() for _, x, _, _ in ins[:9]]
    ptrs.append(None if tri_normal is None else tri_normal.data_ptr())
    ptrs += [x.data_ptr() for _, x, _, _ in tables]
    lib = build.load()
    err = lib.tyrant_shade(*ptrs, ctypes.addressof(consts),
                           *(x.data_ptr() for x in outs),
                           torch.cuda.current_stream(dev).cuda_stream)
    build.check(lib, err, "tyrant_shade launch")
    launches += 1
    return color, survive, next_rays, shadow
