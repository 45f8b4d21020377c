"""The shade stage of the render step in CUDA: one launch of
``csrc/shade.cu`` on the base feature set that ``render._fused_shade``
admits (the sphere materials DIFF, SPEC, REFR, PHONG and LIGHT, triangles
from their tri_shade rows or, with ``tri_normal`` on a
``tri_default_mat`` scene, from the traversal's hit normals, at most one
emissive sphere plus the sun and the analytic sky, the xorshift streams,
no MIS), and two launches of ``csrc/shade_textured.cu`` on the textured
feature set (``render.SHADE_TEXTURED_SCENE``: albedo, normal, roughness
and metalness maps, cutout and blend pass-throughs, GGX; "nearest" or
"bilinear" filtering): :func:`surface`, the hit's surface record, then
:func:`shade_textured`.  Their plain version is ``render._shade_plain``,
which every other configuration and every CPU tensor takes.

The kernels write the tensors the plain body returns, with their dtypes
and layouts (bool as bytes), and launch on the current stream without a
host synchronise or an allocation of their own, so a CUDA graph can
capture them.  The outputs equal the plain body's on the CUDA device on
every slot the step reads: colour, survive and the next ray on every
slot, the shadow ray where it is valid (an invalid one's colour is 0),
except that the textured variant leaves a miss's next origin and shadow
ray, which no stage reads, at its own origin.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ...config import VERY_FAR, SkyConfig
from ...device import constant
from ...sky import RAYLEIGH_AT_X
from . import build

# kernel launches since the last reset: the base kernel's, and the
# textured variant's surface and shade kernels' (one each a shade call)
launches = 0
launches_surface = 0
launches_textured = 0

_INTS = ("n", "max_bounces", "row_offset", "light", "has_light",
         "n_tri_rows", "n_sphere_rows")
_FLOATS = ("eps", "neg2eps", "very_far", "sun_extent", "cos_sun",
           "sun_intensity", "cutoff", "inv_steep", "rzl", "mzl", "ray0",
           "ray1", "ray2", "g2x", "gg", "one_m_gg", "sky_k", "inv_disc")


class _Consts(ctypes.Structure):
    """shade.cu's ShadeConsts, field for field."""

    _fields_ = [(k, ctypes.c_int) for k in _INTS] \
        + [(k, ctypes.c_float) for k in _FLOATS]


class _SurfaceConsts(ctypes.Structure):
    """shade_textured.cu's SurfaceConsts, field for field."""

    _fields_ = [(k, ctypes.c_int) for k in ("n_attr_rows", "n_tex_rows",
                                            "gates", "bilinear")]


# shade_textured.cu's gate bits, by the SceneData flag each stands for,
# and the bit of the traversal's hit normals
GATE_BITS = {"has_albedo_tex": 1, "has_normal_maps": 2, "has_rough_maps": 4,
             "has_metal_maps": 8, "has_alpha_tex": 16, "has_blend": 32,
             "has_ggx": 64}
KERNEL_NORMALS_BIT = 128
# the surface record's material word: the material in its low byte, and
# this bit on a triangle hit that taps an albedo map
TEX_HIT_BIT = 1 << 8
# the texture filters the surface kernel implements
TEXTURE_FILTERS = ("nearest", "bilinear")
# the queue's tensors the surface kernel reads, in its order
_SURFACE_RAYS = ("origin", "direction", "pixel", "t", "ident", "is_tri")


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
    if sky_params is not None:  # the surface kernel reads no sky
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


def _ray_inputs(cfg, rays, t, ident, is_tri) -> list:
    """The queue's tensors both kernels read, checked as _check takes
    them."""
    n = cfg.num_rays
    f32, b8, i32 = torch.float32, torch.bool, torch.int32
    return [("origin", rays["origin"], f32, (n, 3)),
            ("direction", rays["direction"], f32, (n, 3)),
            ("direct", rays["direct"], f32, (n, 3)),
            ("pixel", rays["pixel"], i32, (n,)),
            ("bounces", rays["bounces"], i32, (n,)),
            ("last_specular", rays["last_specular"], b8, (n,)),
            ("t", t, f32, (n,)), ("ident", ident, i32, (n,)),
            ("is_tri", is_tri, b8, (n,))]


def _device_of(t):
    dev = t.device
    if dev.type != "cuda":
        raise ValueError(f"the shade kernel needs CUDA tensors, got {dev}")
    return dev


def _outputs(n: int, dev, pixel):
    """(color, survive, next_rays, shadow) as the plain body returns
    them, empty, and the list of the buffers in the kernels' order."""
    f32, b8, i32 = torch.float32, torch.bool, torch.int32

    def empty(*shape, dtype=f32):
        return torch.empty(shape, dtype=dtype, device=dev)
    color, survive = empty(n, 3), empty(n, dtype=b8)
    next_rays = dict(origin=empty(n, 3), direction=empty(n, 3),
                     direct=empty(n, 3), pixel=pixel,
                     bounces=empty(n, dtype=i32),
                     last_specular=empty(n, dtype=b8))
    shadow = dict(origin=empty(n, 3), direction=empty(n, 3),
                  color=empty(n, 3), max_dist=empty(n), valid=empty(n,
                                                                    dtype=b8))
    outs = [color, survive, next_rays["origin"], next_rays["direction"],
            next_rays["direct"], next_rays["bounces"],
            next_rays["last_specular"], shadow["origin"],
            shadow["direction"], shadow["color"], shadow["max_dist"],
            shadow["valid"]]
    return (color, survive, next_rays, shadow), outs


def _sky_tables(scene, sky_params, sun_dir, frame, dev) -> list:
    f32 = torch.float32
    frame = torch.as_tensor(frame, dtype=torch.int64, device=dev)
    return [("sphere_table", scene.sphere_table, f32,
             (scene.sphere_table.shape[0], 12)),
            ("sun_dir", sun_dir.to(dev, f32).contiguous(), f32, (3,)),
            ("total_mie", sky_params.total_mie(dev), f32, (3,)),
            ("frame", frame, torch.int64, ())]


def shade(cfg, scene, sky_params, sun_dir, rays, t, ident, is_tri, frame,
          tri_normal=None, row_offset: int = 0):
    """``render._shade`` in one kernel launch, for CUDA tensors: (color,
    survive, next_rays, shadow).  ``tri_normal`` [N, 3]: the traversal's
    hit normals on a ``tri_default_mat`` scene (the kernel's normals
    variant), else None (the tri_shade rows).  ``frame`` is the salted
    frame counter, an int64 tensor on the device (read by the kernel, so a
    captured graph sees each replay's)."""
    global launches
    n, dev = cfg.num_rays, _device_of(t)
    ins = _ray_inputs(cfg, rays, t, ident, is_tri)
    if tri_normal is not None:
        ins.append(("tri_normal", tri_normal, torch.float32, (n, 3)))
    tables = [("tri_shade", scene.tri_shade, torch.float32,
               (scene.tri_shade.shape[0], 8))] \
        + _sky_tables(scene, sky_params, sun_dir, frame, dev)
    _check(dev, ins + tables)
    result, outs = _outputs(n, dev, rays["pixel"])
    consts = _consts(cfg, scene, sky_params, row_offset)
    ptrs = [x.data_ptr() for _, x, _, _ in ins[:9]]
    ptrs.append(None if tri_normal is None else tri_normal.data_ptr())
    ptrs += [x.data_ptr() for _, x, _, _ in tables]
    lib = build.load()
    err = lib.tyrant_shade(*ptrs, ctypes.addressof(consts),
                           *(x.data_ptr() for x in outs),
                           torch.cuda.current_stream(dev).cuda_stream)
    build.check(lib, err, "tyrant_shade launch")
    launches += 1
    return result


def _gates(scene, kernel_normals: bool = False) -> int:
    """shade_textured.cu's gate bits for ``scene``'s flags, with the bit
    of the traversal's hit normals under ``kernel_normals``."""
    bits = sum(b for k, b in GATE_BITS.items() if getattr(scene, k))
    return bits | (KERNEL_NORMALS_BIT if kernel_normals else 0)


def _tex_meta(scene, dev):
    """``scene.tex_meta`` as the kernel reads it: [K, 5] int32 (offset,
    height, width, wrap_s, wrap_t), made once a device; None without
    textures."""
    if not scene.tex_meta:
        return None
    return constant(tuple((int(m[0]), int(m[1]), int(m[2]),
                           int(m[3]) if len(m) > 3 else 0,
                           int(m[4]) if len(m) > 4 else 0)
                          for m in scene.tex_meta), dev, torch.int32)


def surface(cfg, scene, rays, t, ident, is_tri, frame, tri_normal=None,
            row_offset: int = 0):
    """The textured variant's first launch: the surface record [N, 8] f32
    of every queue slot (the shading normal, the roughness; the colour,
    and the material word: the material with the metal and blend picks
    and the pass-through resolved, DIFF on a miss, plus TEX_HIT_BIT on a
    triangle hit that taps an albedo map), from the hit's tri_shade and
    tri_attr rows and the atlas taps under ``cfg.texture_filter`` (one of
    TEXTURE_FILTERS).  ``tri_normal``: the traversal's hit normals on a
    ``tri_default_mat`` scene, else None."""
    global launches_surface
    n, dev = cfg.num_rays, _device_of(t)
    if cfg.texture_filter not in TEXTURE_FILTERS:
        raise ValueError(f"the textured shade kernel filters "
                         f"{TEXTURE_FILTERS}, not {cfg.texture_filter!r}")
    f32 = torch.float32
    ins = [x for x in _ray_inputs(cfg, rays, t, ident, is_tri)
           if x[0] in _SURFACE_RAYS]
    if tri_normal is not None:
        ins.append(("tri_normal", tri_normal, f32, (n, 3)))
    meta = _tex_meta(scene, dev)
    frame = torch.as_tensor(frame, dtype=torch.int64, device=dev)
    tables = [("tri_shade", scene.tri_shade, f32,
               (scene.tri_shade.shape[0], 8)),
              ("tri_attr", scene.tri_attr, f32,
               (scene.tri_attr.shape[0], 32)),
              ("sphere_table", scene.sphere_table, f32,
               (scene.sphere_table.shape[0], 12)),
              ("frame", frame, torch.int64, ())]
    if meta is not None:
        tables += [("tex_data", scene.tex_data, f32,
                    (scene.tex_data.shape[0], 4)),
                   ("tex_meta", meta, torch.int32, (meta.shape[0], 5))]
    _check(dev, ins + tables)
    record = torch.empty((n, 8), dtype=f32, device=dev)
    consts = _consts(cfg, scene, None, row_offset)
    sc = _SurfaceConsts(n_attr_rows=scene.tri_attr.shape[0],
                        n_tex_rows=0 if meta is None
                        else scene.tex_data.shape[0],
                        gates=_gates(scene, tri_normal is not None),
                        bilinear=int(cfg.texture_filter == "bilinear"))
    ptrs = [x.data_ptr() for _, x, _, _ in ins[:6]]
    ptrs.append(None if tri_normal is None else tri_normal.data_ptr())
    ptrs += [x.data_ptr() for _, x, _, _ in tables[:4]]
    ptrs += [None, None] if meta is None \
        else [scene.tex_data.data_ptr(), meta.data_ptr()]
    lib = build.load()
    err = lib.tyrant_shade_surface(
        *ptrs, ctypes.addressof(consts), ctypes.addressof(sc),
        record.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    build.check(lib, err, "tyrant_shade_surface launch")
    launches_surface += 1
    return record


def shade_textured(cfg, scene, sky_params, sun_dir, rays, t, ident, is_tri,
                   frame, record, row_offset: int = 0):
    """The textured variant's second launch: ``render._shade`` from the
    ray, the hit and the surface record of :func:`surface`, for CUDA
    tensors: (color, survive, next_rays, shadow)."""
    global launches_textured
    n, dev = cfg.num_rays, _device_of(t)
    ins = _ray_inputs(cfg, rays, t, ident, is_tri)[:8]
    ins.append(("record", record, torch.float32, (n, 8)))
    tables = _sky_tables(scene, sky_params, sun_dir, frame, dev)
    _check(dev, ins + tables)
    result, outs = _outputs(n, dev, rays["pixel"])
    consts = _consts(cfg, scene, sky_params, row_offset)
    lib = build.load()
    err = lib.tyrant_shade_textured(
        *(x.data_ptr() for _, x, _, _ in ins + tables),
        ctypes.addressof(consts), _gates(scene),
        *(x.data_ptr() for x in outs),
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(lib, err, "tyrant_shade_textured launch")
    launches_textured += 1
    return result
