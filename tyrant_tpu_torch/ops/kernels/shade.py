"""The shade stage of the render step in CUDA, and the one place that
decides which shade calls a kernel takes (:func:`variant`, from the gate
table below) and runs them (:func:`run`).  The base kernel,
``csrc/shade.cu``, is one launch on the base feature set (the sphere
materials DIFF, SPEC, REFR, PHONG and LIGHT, triangles from their
tri_shade rows or, with ``tri_normal`` on a ``tri_default_mat`` scene,
from the traversal's hit normals, at most one emissive sphere plus the
sun and the analytic sky, the xorshift streams, no MIS).  The textured
variant, ``csrc/shade_textured.cu``, is two launches on the textured
feature set (the flags of :data:`GATE_BITS`: albedo, normal, roughness
and metalness maps, cutout and blend pass-throughs, GGX; a filter of
:data:`TEXTURE_FILTERS`): :func:`surface`, the hit's surface record,
then :func:`shade_textured`.  Their plain version is
``render._shade_plain``, which every other call and every CPU tensor
takes.

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
from ...scene.scene import GGX, PASS
from ...sky import RAYLEIGH_AT_X
from ...utils import profiling as _prof
from . import build

# kernel launches since the last reset: the base kernel's, and the
# textured variant's surface and shade kernels' (one each a shade call)
launches = 0
launches_surface = 0
launches_textured = 0

# The gate table.  A shade call goes to the plain body where a SceneData
# attribute of PLAIN_SCENE is truthy, or a RenderConfig field of
# KERNEL_CONFIG holds another value than the kernels'.  Where a flag of
# GATE_BITS is truthy, the textured variant takes the call under a
# texture_filter of TEXTURE_FILTERS, the plain body under any other.
PLAIN_SCENE = ("has_envmap", "smooth_normals", "has_rrefr", "has_var_ior",
               "n_tri_lights", "n_delta_lights")
KERNEL_CONFIG = {"sampler": "xorshift", "mis": "off", "fog": "off",
                 "dispersion": 0.0}
# the textured flags, each with its bit in shade_textured.cu's gates,
# and the bit of the traversal's hit normals
GATE_BITS = {"has_albedo_tex": 1, "has_normal_maps": 2, "has_rough_maps": 4,
             "has_metal_maps": 8, "has_alpha_tex": 16, "has_blend": 32,
             "has_ggx": 64}
KERNEL_NORMALS_BIT = 128
# the texture filters the surface kernel implements
TEXTURE_FILTERS = ("nearest", "bilinear")
# what :func:`variant` returns
BASE, TEXTURED = "base", "textured"
# the surface record's material word: the material in its low byte, and
# this bit on a triangle hit that taps an albedo map
TEX_HIT_BIT = 1 << 8

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


def variant(cfg, scene, device) -> str | None:
    """Which kernel takes a shade call on ``device``: None (the plain
    body) off CUDA, where a gate of PLAIN_SCENE or KERNEL_CONFIG is on, or
    without one light sphere or none (several are a light pick the
    kernels leave out) among at least one sphere; else TEXTURED where a
    flag of GATE_BITS is on (None under a texture_filter outside
    TEXTURE_FILTERS), BASE where none is."""
    if not (torch.device(device).type == "cuda"
            and all(getattr(cfg, k) == v for k, v in KERNEL_CONFIG.items())
            and not any(getattr(scene, k) for k in PLAIN_SCENE)
            and scene.n_spheres > 0 and len(scene.light_indices) <= 1):
        return None
    if not any(getattr(scene, k) for k in GATE_BITS):
        return BASE
    return TEXTURED if cfg.texture_filter in TEXTURE_FILTERS else None


def run(kind: str, cfg, scene, sky_params, sun_dir, rays, t, ident, is_tri,
        frame, tri_normal=None, row_offset: int = 0):
    """``render._shade`` on the kernel ``kind`` of :func:`variant`: one
    launch of :func:`shade` (BASE), or :func:`surface` then
    :func:`shade_textured` (TEXTURED; with the tracer on, the
    ``fetch_end`` marker between them, and the counters ``tex_hits``,
    ``alpha_pass`` and ``ggx_hits`` from the surface record's material
    words).  With the tracer on, either counts ``shade_fused`` (the slots
    it shaded) and ``roulette_kills``.  ``tri_normal``: the traversal's
    hit normals on a ``tri_default_mat`` scene, else None.  Returns
    (color, survive, next_rays, shadow)."""
    if kind == TEXTURED:
        record = surface(cfg, scene, rays, t, ident, is_tri, frame,
                         tri_normal, row_offset)
        if _prof.ON:
            _prof.mark(t.device, _prof.FETCH_END)
            word = record.view(torch.int32)[:, 7]  # a view: no launch
            _prof.defer("tex_hits", lambda: ((word & TEX_HIT_BIT) != 0).sum())
            _prof.defer("alpha_pass", lambda: ((word & 0xFF) == PASS).sum())
            _prof.defer("ggx_hits", lambda: ((word & 0xFF) == GGX).sum())
        out = shade_textured(cfg, scene, sky_params, sun_dir, rays, t, ident,
                             is_tri, frame, record, row_offset)
    else:
        out = shade(cfg, scene, sky_params, sun_dir, rays, t, ident, is_tri,
                    frame, tri_normal, row_offset)
    if _prof.ON:
        survive = out[1]
        _prof.defer("shade_fused", lambda: cfg.num_rays)
        _prof.defer("roulette_kills", lambda: (
            (t < VERY_FAR) & (rays["bounces"] < cfg.max_bounces)
            & ~survive).sum())
    return out


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


def _pointers(dev, args) -> list:
    """The data pointers of ``args`` in order: each a (name, tensor, dtype,
    shape) entry, checked to be a contiguous ``dtype`` tensor of ``shape``
    on ``dev``, or None, an input the launch leaves out (a null
    pointer)."""
    for a in args:
        if a is None:
            continue
        name, x, dtype, shape = a
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, t on {dev}")
        if x.dtype != dtype or tuple(x.shape) != shape \
                or not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous {dtype} of shape "
                             f"{shape}, got {x.dtype} {tuple(x.shape)}")
    return [None if a is None else a[1].data_ptr() for a in args]


def _ray_inputs(cfg, rays, t, ident, is_tri) -> list:
    """The queue's tensors the kernels read, as _pointers takes them."""
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


def _shade_launch(entry: str, cfg, scene, sky_params, sun_dir, rays, t,
                  frame, ins, row_offset: int, *gates):
    """The launch both shade kernels make: ``ins`` (the ray, hit and
    surface inputs), the sphere table and the sky's, the constants,
    ``gates``, the outputs.  Returns (color, survive, next_rays,
    shadow)."""
    dev = t.device
    frame = torch.as_tensor(frame, dtype=torch.int64, device=dev)
    ptrs = _pointers(dev, ins + [
        ("sphere_table", scene.sphere_table, torch.float32,
         (scene.sphere_table.shape[0], 12)),
        ("sun_dir", sun_dir.to(dev, torch.float32).contiguous(),
         torch.float32, (3,)),
        ("total_mie", sky_params.total_mie(dev), torch.float32, (3,)),
        ("frame", frame, torch.int64, ())])
    result, outs = _outputs(cfg.num_rays, dev, rays["pixel"])
    consts = _consts(cfg, scene, sky_params, row_offset)
    build.launch(entry, dev, *ptrs, ctypes.addressof(consts), *gates,
            *(x.data_ptr() for x in outs))
    return result


def shade(cfg, scene, sky_params, sun_dir, rays, t, ident, is_tri, frame,
          tri_normal=None, row_offset: int = 0):
    """The base kernel: ``render._shade`` in one launch, for CUDA
    tensors: (color, survive, next_rays, shadow).  ``tri_normal`` [N, 3]:
    the traversal's hit normals on a ``tri_default_mat`` scene (the
    kernel's normals variant), else None (the tri_shade rows).  ``frame``
    is the salted frame counter, an int64 tensor on the device (read by
    the kernel, so a captured graph sees each replay's)."""
    global launches
    _device_of(t)
    ins = _ray_inputs(cfg, rays, t, ident, is_tri) + [
        None if tri_normal is None
        else ("tri_normal", tri_normal, torch.float32, (cfg.num_rays, 3)),
        ("tri_shade", scene.tri_shade, torch.float32,
         (scene.tri_shade.shape[0], 8))]
    result = _shade_launch("tyrant_shade", cfg, scene, sky_params, sun_dir,
                           rays, t, frame, ins, row_offset)
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
    meta = _tex_meta(scene, dev)
    frame = torch.as_tensor(frame, dtype=torch.int64, device=dev)
    origin, direction, _, pixel, _, _, *hit = _ray_inputs(cfg, rays, t,
                                                          ident, is_tri)
    ptrs = _pointers(dev, [
        origin, direction, pixel, *hit,
        None if tri_normal is None
        else ("tri_normal", tri_normal, f32, (n, 3)),
        ("tri_shade", scene.tri_shade, f32, (scene.tri_shade.shape[0], 8)),
        ("tri_attr", scene.tri_attr, f32, (scene.tri_attr.shape[0], 32)),
        ("sphere_table", scene.sphere_table, f32,
         (scene.sphere_table.shape[0], 12)),
        ("frame", frame, torch.int64, ()),
        None if meta is None
        else ("tex_data", scene.tex_data, f32, (scene.tex_data.shape[0], 4)),
        None if meta is None
        else ("tex_meta", meta, torch.int32, (meta.shape[0], 5))])
    record = torch.empty((n, 8), dtype=f32, device=dev)
    consts = _consts(cfg, scene, None, row_offset)
    sc = _SurfaceConsts(n_attr_rows=scene.tri_attr.shape[0],
                        n_tex_rows=0 if meta is None
                        else scene.tex_data.shape[0],
                        gates=_gates(scene, tri_normal is not None),
                        bilinear=int(cfg.texture_filter == "bilinear"))
    build.launch("tyrant_shade_surface", dev, *ptrs, ctypes.addressof(consts),
            ctypes.addressof(sc), record.data_ptr())
    launches_surface += 1
    return record


def shade_textured(cfg, scene, sky_params, sun_dir, rays, t, ident, is_tri,
                   frame, record, row_offset: int = 0):
    """The textured variant's second launch: ``render._shade`` from the
    ray, the hit and the surface record of :func:`surface`, for CUDA
    tensors: (color, survive, next_rays, shadow)."""
    global launches_textured
    _device_of(t)
    ins = _ray_inputs(cfg, rays, t, ident, is_tri)[:8] + [
        ("record", record, torch.float32, (cfg.num_rays, 8))]
    result = _shade_launch("tyrant_shade_textured", cfg, scene, sky_params,
                           sun_dir, rays, t, frame, ins, row_offset,
                           _gates(scene))
    launches_textured += 1
    return result
