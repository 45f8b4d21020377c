"""The wavefront render step, the port of ``tyrant_tpu/render.py`` for the
main path (the reference estimator at the default static gates), the
loaded-scene materials (GGX conductors, rough glass, a per-triangle glass
IOR, spectral dispersion and smooth vertex normals, in scenes with or
without spheres), the lights (several emissive spheres, emissive
triangles, point/spot/directional delta lights, uniform or power light
picking (``light_sampling``), an equirectangular environment map and
multiple importance sampling (``mis``) with environment next-event
estimation), textured surfaces (albedo with alpha cutout and stochastic
blend, tangent-space normal maps, roughness and metalness maps, the three
wrap modes, ``texture_filter`` nearest, bilinear or trilinear over the
mip pyramid), height fog (``fog``: a slab of exponential-height
density with Henyey-Greenstein scattering) and the rest of RenderConfig:
the Sobol sampler (``sampler``, ``seed``), the fisheye, equirect and
orthographic projections, the polygonal aperture, motion blur, the crop
window, the radiance clamp, adaptive sampling and the second moments
(``track_variance``).

One :func:`render_step` tops up the fixed-size ray queue with camera rays
(raygen), finds every ray's closest hit (extend), shades it with a BSDF
sample, a next-event shadow ray and Russian roulette (shade), tests the
shadow rays (connect), and runs one stable sort that both compacts the
survivors for the next step and orders finished paths by pixel for the
accumulation.  Extend and connect go through a traversal kernel (the
generation ``packet_kernel_mode`` selects), the accumulation through
the accumulation kernel and shade, where ``ops/kernels/shade.variant``
picks one, through a shade kernel (``ops/kernels``); the rest is plain
PyTorch.
:class:`Renderer` also resolves the display image, optionally denoised
with the guides of one AOV pass per pose (:func:`render_aovs`) and
bloomed.

The light tables shade reads (``SceneData``): ``tri_lights`` rows
[K, 13] v0, e1, e2, emission, area; ``delta_lights`` rows [L, 12] kind,
position, unit axis, intensity, cos_inner, cos_outer; the power pick's
``light_cdf`` and ``light_inv_pdf`` (up to 64 lights) or ``light_alias``
rows [keep, alias, 1/pdf(self), 1/pdf(alias)] (beyond); ``env_data``
[H*W+1, 4] radiance and, in lane 3, the texel's solid-angle pdf, and
``env_alias`` [H*W, 12] for the environment draws; ``tri_shade`` lane 7
holds a LIGHT triangle's area, which the MIS emitter-hit pdf reads.  The
texture taps read ``tex_data`` rows, one row gather a tap, addressed from
the static ``tex_meta`` tuple by a Python select chain.

Every material, light, texture and scene term is gated in Python on the
scene's flags and counts (``SceneData.has_ggx``, ``has_rrefr``,
``has_var_ior``, ``smooth_normals``, the texture gates, no spheres,
``light_indices``, ``n_tri_lights``, ``n_delta_lights``, ``has_envmap``)
and on the config (``dispersion``, ``mis``, ``fog``, ``sampler``,
``projection``, ``motion_blur``, ...), as the JAX package gates them at
trace time, so a scene without them issues the same device operations as
the main path.  Every uniform is drawn in the JAX package's order, from
the same streams.

State lives in tensors on one device.  Unlike the JAX package, the step
updates ``state.accum`` (and ``state.moment2``) in place (the JAX
Renderer donates its state).
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from . import adaptive as adaptive_mod
from . import sky as skymod
from .camera import Camera, CameraParams
from .config import INV_PI, PI, VERY_FAR, RenderConfig
from .denoise import atrous_denoise
from .device import resolve
from .ops import kernels, rng, sobol
from .ops.kernels import shade as kshade
from .ops.kernels import spheres as kspheres
from .ops.kernels.accum import accumulate_terminated, sentinel
from .ops.kernels.traverse import (PacketTables, any_hit_packets,
                                   closest_hit_packets)
from .ops.sampling import (concentric_sample_disk, cone_sample,
                           cone_sample_from_uniforms, cross,
                           cosine_hemisphere_from_uniforms,
                           cosine_hemisphere_sample, dot, ggx_d_vec, ggx_g1,
                           ggx_vndf_sample_from_uniforms, hg_phase,
                           hg_sample_from_uniforms, normalize,
                           phong_lobe_sample, polygon_sample_disk, reflect,
                           sphere_surface_from_uniforms,
                           sphere_surface_sample,
                           triangle_sample_from_uniforms)
from .ops.tonemap import bloom, to_uint8, tonemap_image
from .scene.envlight import LUM_RGB
from .scene.scene import (DIFF, FOG, GGX, LIGHT, PASS, PHONG, REFR, RREFR,
                          SPEC, Scene, SceneData)
from .utils import profiling as _prof

PHONG_EXPONENT = 40.0
_KEY_GRID = 8  # survivor-ordering spatial grid resolution

@dataclasses.dataclass
class RenderState:
    """Render state: accumulation buffer, carried ray queue, counters.

    Scalars are 0-d int64 tensors on the state's device, so a step never
    waits for the device."""

    accum: torch.Tensor          # [P, 4] rgb radiance sum, a = paths
    origin: torch.Tensor         # [N, 3]
    direction: torch.Tensor      # [N, 3]
    direct: torch.Tensor         # [N, 3] path throughput
    pending: torch.Tensor        # [N, 3] radiance not yet flushed
    pixel: torch.Tensor          # [N] i32
    bounces: torch.Tensor        # [N] i32
    last_specular: torch.Tensor  # [N] bool
    n_carried: torch.Tensor      # survivors at the queue's tail
    start_position: torch.Tensor  # raygen round-robin counter
    frame: torch.Tensor          # RNG frame counter (uint32 value)
    shadow_rays: torch.Tensor    # valid NEE shadow rays traced so far
    # [N] solid-angle pdf of the BSDF sample that made each carried ray
    # (the MIS balance weight at its emitter or sky hit); [1] ones when
    # cfg.mis is "off"
    bsdf_pdf: torch.Tensor
    # [P, 4] per-pixel sums of the squared radiance and the path count
    # (adaptive sampling and track_variance), else [1, 4] zeros
    moment2: torch.Tensor
    # [P] i32 raygen visit order under adaptive sampling, else [1]
    pixel_perm: torch.Tensor
    # Sobol: the round-robin passes raygen has completed (a pixel's sample
    # index is this plus the scan's wrap count) and each carried ray's own
    # sample index [N] (u32 values as int64), else [1]
    sample_base: torch.Tensor
    sample_idx: torch.Tensor


def _moments(cfg: RenderConfig) -> bool:
    """Whether the step flushes the second moments."""
    return cfg.adaptive_sampling == "on" or cfg.track_variance == "on"


def init_state(cfg: RenderConfig, device,
               local_height: int | None = None) -> RenderState:
    """A fresh state for the whole frame, or with ``local_height`` for
    one row strip of that many rows (the strip-parallel path,
    :mod:`~tyrant_tpu_torch.parallel.sharded`): its accumulation and
    adaptive visit order cover the strip's pixels, in local ids."""
    h = cfg.height if local_height is None else local_height
    n, p = cfg.num_rays, cfg.width * h

    def scalar(v):
        return torch.tensor(v, dtype=torch.int64, device=device)
    adaptive = cfg.adaptive_sampling == "on"
    return RenderState(
        accum=torch.zeros((p, 4), dtype=torch.float32, device=device),
        origin=torch.zeros((n, 3), dtype=torch.float32, device=device),
        direction=torch.tensor([[1.0, 0.0, 0.0]], device=device).repeat(n, 1),
        direct=torch.zeros((n, 3), dtype=torch.float32, device=device),
        pending=torch.zeros((n, 3), dtype=torch.float32, device=device),
        pixel=torch.zeros((n,), dtype=torch.int32, device=device),
        bounces=torch.zeros((n,), dtype=torch.int32, device=device),
        last_specular=torch.zeros((n,), dtype=torch.bool, device=device),
        n_carried=scalar(0), start_position=scalar(0),
        frame=scalar(1),  # never 0: it keys the RNG
        shadow_rays=scalar(0),
        bsdf_pdf=torch.ones((n if cfg.mis == "on" else 1,),
                            dtype=torch.float32, device=device),
        moment2=torch.zeros((p if _moments(cfg) else 1, 4),
                            dtype=torch.float32, device=device),
        pixel_perm=(adaptive_mod.identity_perm(p, device) if adaptive
                    else torch.zeros((1,), dtype=torch.int32,
                                     device=device)),
        sample_base=scalar(0),
        sample_idx=torch.zeros((n if cfg.sampler == "sobol" else 1,),
                               dtype=torch.int64, device=device))


def reset_accumulation(state: RenderState) -> RenderState:
    """Camera or sun moved: zero the accumulation buffer and the second
    moments, drop the carried rays, put an adaptive visit order back to
    the identity and restart every pixel's Sobol sequence."""
    perm = state.pixel_perm
    if perm.shape[0] > 1:
        perm = adaptive_mod.identity_perm(perm.shape[0], perm.device)
    return dataclasses.replace(
        state, accum=torch.zeros_like(state.accum),
        moment2=torch.zeros_like(state.moment2), pixel_perm=perm,
        sample_base=torch.zeros_like(state.sample_base),
        n_carried=torch.zeros_like(state.n_carried))


# --------------------------------------------------------------------------
# raygen
# --------------------------------------------------------------------------

def _rows(v):
    """A camera field [3] as [1, 3]; per-ray fields [n, 3] unchanged."""
    return v if v.ndim == 2 else v[None]


def _primary_dirs(cfg: RenderConfig, camera, ni, nj):
    """Image-plane coordinates (``ni`` in [-0.5, 0.5) left to right,
    ``nj`` bottom to top) to primary directions under ``cfg.projection``.
    Returns (dir [n, 3], origin offset [n, 3] or None, live [n] or None):
    the orthographic camera shifts the ray's start off the pinhole, and
    the fisheye marks the rays inside its image circle (those outside
    render black).  "perspective" is the reference's basis (its scale in
    camera.right/up); the other modes use the unit basis.  The camera's
    fields may be [3] or, under motion blur, [n, 3] (a pose a ray)."""
    cdir, cright, cup = _rows(camera.direction), _rows(camera.right), \
        _rows(camera.up)
    if cfg.projection == "perspective":
        return normalize(cdir + ni[:, None] * cright + nj[:, None] * cup), \
            None, None
    # right/up carry the perspective's 1.5 * aspect scale: the unit frame
    ru = normalize(cright)
    uu = normalize(cup)
    fwd = cdir
    aspect = cfg.width / cfg.height
    if cfg.projection == "fisheye":
        # equidistant: the angle from the axis is linear in the radius of
        # the image circle, which is inscribed in the image height
        u = 2.0 * ni * aspect
        v = 2.0 * nj
        r = torch.sqrt(u * u + v * v)
        theta = r * (0.5 * cfg.fisheye_fov_degrees * (PI / 180.0))
        phi = torch.atan2(v, torch.where(r > 0.0, u, 1.0))
        st, ct = torch.sin(theta), torch.cos(theta)
        d = ct[:, None] * fwd + (st * torch.cos(phi))[:, None] * ru \
            + (st * torch.sin(phi))[:, None] * uu
        return normalize(d), None, r <= 1.0
    if cfg.projection == "equirect":
        # a 360x180 latitude-longitude panorama around the view direction
        lon = (2.0 * PI) * ni
        lat = PI * nj
        cl = torch.cos(lat)
        d = (cl * torch.cos(lon))[:, None] * fwd \
            + (cl * torch.sin(lon))[:, None] * ru \
            + torch.sin(lat)[:, None] * uu
        return normalize(d), None, None
    # "ortho": rays along the view axis from a shifted origin
    off = (ni * (cfg.ortho_height * aspect))[:, None] * ru \
        + (nj * cfg.ortho_height)[:, None] * uu
    d = fwd.expand(off.shape[0], 3) if fwd.shape[0] == 1 else normalize(fwd)
    return d, off, None


def _scan_total(cfg: RenderConfig, local_height: int | None = None) -> int:
    """Pixels one round-robin raygen pass covers: the crop window's, else
    the frame's, or a row strip's of ``local_height`` rows."""
    if cfg.crop is not None:
        return int(cfg.crop[2]) * int(cfg.crop[3])
    return cfg.width * (cfg.height if local_height is None else local_height)


def _salted_frame(cfg: RenderConfig, frame):
    """The frame counter keying the step's xorshift streams: with
    ``cfg.seed`` offset by seed * 2654435761 (mod 2^32), which re-keys
    them all; seed 0 leaves it as it is."""
    if not cfg.seed:
        return frame
    return (frame + ((cfg.seed * 2654435761) & 0xFFFFFFFF)) & 0xFFFFFFFF


def _raygen(cfg: RenderConfig, camera: CameraParams, start_position, frame,
            perm=None, sample_base=None, cam_prev=None,
            local_height: int | None = None, row_offset: int = 0):
    """Fresh camera rays for every queue slot (the merge keeps carried
    survivors in the tail slots).  ``perm``: the adaptive visit order;
    ``sample_base``: the Sobol pass counter; ``cam_prev``: the previous
    pose that motion blur lerps from.  ``frame`` is the salted one.  A
    row strip (``local_height`` rows from image row ``row_offset``) scans
    its own pixels in local ids; the offset moves each ray's image row and
    enters every seed, so strips draw independent streams."""
    n = cfg.num_rays
    w, h = cfg.width, cfg.height
    local_h = h if local_height is None else local_height
    dev = camera.position.device
    total = _scan_total(cfg, local_height)
    gen_index = torch.arange(n, dtype=torch.int64, device=dev)
    scan = (start_position + gen_index) % total
    tiled = cfg.raygen_order == "tiled8"
    if cfg.crop is not None:
        # the scan covers the crop window, in 8x8 tiles when they fit
        cx0, cy0, cw, ch = (int(v) for v in cfg.crop)
        if tiled and cw % 8 == 0 and ch % 8 == 0:
            tile = scan // 64
            within = scan % 64
            cx = (tile % (cw // 8)) * 8 + within % 8
            cy = (tile // (cw // 8)) * 8 + within // 8
        else:
            cx = scan % cw
            cy = scan // cw
        x_i = cx0 + cx
        y_i = cy0 + cy
        pixel = y_i * w + x_i
    elif perm is not None:
        # adaptive sampling: the visit order, with repetition
        pixel = perm[scan].to(torch.int64)
        x_i = pixel % w
        y_i = pixel // w
    elif tiled and w % 8 == 0 and local_h % 8 == 0:
        # 8x8 screen tiles: consecutive rays share a tile (coherent packets)
        tile = scan // 64
        within = scan % 64
        x_i = (tile % (w // 8)) * 8 + within % 8
        y_i = (tile // (w // 8)) * 8 + within // 8
        pixel = y_i * w + x_i
    else:
        pixel = scan
        x_i = pixel % w
        y_i = pixel // w
    x = x_i.to(torch.float32)
    y = (y_i + row_offset if row_offset else y_i).to(torch.float32)

    salt = (cfg.seed,) if cfg.seed else ()
    sample_idx = None
    if cfg.sampler == "sobol":
        # pixel p's k-th path is the one made on wrap k of the counter
        sample_idx = (sample_base + (start_position + gen_index) // total) \
            & 0xFFFFFFFF
        key = rng.seed_prefix(pixel, row_offset, *salt)
        ju, jv = sobol.sample_2d(sample_idx,
                                 rng.seed_from(0x50B01, prefix=key))
        px = x - ju
        py = y - jv
    else:
        seed = rng.seed_from(frame, gen_index, row_offset, 0x5EED)
        seed, uv = rng.random_2d_stratified(seed)
        px = x - uv[..., 0]  # the reference subtracts the jitter
        py = y - uv[..., 1]
    ni = px / w - 0.5
    nj = (h - py) / h - 0.5

    cam_i = camera
    if cfg.motion_blur > 0.0 and cam_prev is not None:
        # each ray sees the pose lerped from the previous one at a shutter
        # time s in (1 - shutter, 1], drawn on a side stream (the other
        # streams stay as without blur)
        _, ut = rng.random_float(rng.seed_from(frame, gen_index, row_offset,
                                               0x7131))
        s_t = (1.0 - cfg.motion_blur * ut)[:, None]

        def lerp(cur, prev):
            return prev[None] + s_t * (cur - prev)[None]

        cam_i = CameraParams(
            position=lerp(camera.position, cam_prev.position),
            direction=normalize(lerp(camera.direction, cam_prev.direction)),
            right=lerp(camera.right, cam_prev.right),
            up=lerp(camera.up, cam_prev.up),
            focal_distance=camera.focal_distance,
            lens_radius=camera.lens_radius)

    dir_fp, o_off, live = _primary_dirs(cfg, cam_i, ni, nj)
    base = _rows(cam_i.position) if o_off is None \
        else _rows(cam_i.position) + o_off
    conv = base + (cam_i.focal_distance * cfg.focal_distance_scale) * dir_fp
    if cfg.sampler == "sobol":
        l0, l1 = sobol.sample_2d(sample_idx,
                                 rng.seed_from(0x50B02, prefix=key))
    else:
        seed, l0 = rng.random_float(seed)
        seed, l1 = rng.random_float(seed)
    lens_u = torch.stack([l0, l1], dim=-1)
    if cfg.bokeh_blades:
        # a polygonal aperture: out-of-focus highlights take the iris shape
        p_lens = cam_i.lens_radius * polygon_sample_disk(
            lens_u, cfg.bokeh_blades, math.radians(cfg.bokeh_rotation))
    else:
        p_lens = cam_i.lens_radius * concentric_sample_disk(lens_u)
    origin = base + p_lens[:, 0:1] * _rows(cam_i.right) \
        + p_lens[:, 1:2] * _rows(cam_i.up)
    direction = normalize(conv - origin)
    direct = torch.ones((n, 3), dtype=torch.float32, device=dev)
    if live is not None:
        # outside the fisheye's circle: zero throughput, but the path ends
        # as usual, so the pixel's path count stays exact
        direct = direct * live[:, None].to(torch.float32)
    out = dict(origin=origin, direction=direction, direct=direct,
               pending=torch.zeros((n, 3), dtype=torch.float32, device=dev),
               pixel=pixel.to(torch.int32),
               bounces=torch.zeros((n,), dtype=torch.int32, device=dev),
               # RayQueue default: lastSpecular = true
               last_specular=torch.ones((n,), dtype=torch.bool, device=dev))
    if sample_idx is not None:
        out["sample_idx"] = sample_idx
    return out


# --------------------------------------------------------------------------
# extend
# --------------------------------------------------------------------------

def _pick_wave(cfg: RenderConfig) -> bool:
    """Traversal-kernel generation of every stage that traverses (extend,
    connect, the AOV pass): the warp-packet wave kernel under "wave" (and
    its deprecated spelling "wave-unsafe"), the one-ray-per-thread kernel
    under "mono" and "auto".  The JAX package's per-stage "auto" table was
    set from TPU measurements; the port's "auto" stays mono on every stage
    until the H100's in-step numbers give it a per-stage table."""
    return cfg.packet_kernel_mode in ("wave", "wave-unsafe")


def kernel_normals(cfg: RenderConfig, scene: SceneData) -> bool:
    """Whether extend returns the traversal's hit normals for shade to
    use: under ``use_kernel_normals`` "on", on a ``tri_default_mat`` scene
    (every triangle of the default material, the one triangle shading
    they replace)."""
    return cfg.use_kernel_normals == "on" and scene.tri_default_mat


def sphere_pass(origin, direction, scene: SceneData):
    """The closest sphere hit (t [N], sphere id [N] i32), VERY_FAR and -1
    on a miss and on every ray of a scene without spheres."""
    if scene.n_spheres == 0:
        n = origin.shape[0]
        return (torch.full((n,), VERY_FAR, dtype=origin.dtype,
                           device=origin.device),
                torch.full((n,), -1, dtype=torch.int32, device=origin.device))
    return kspheres.closest(origin, direction, scene.sphere_center,
                            scene.sphere_radius)


def _intersect_scene(origin, direction, scene: SceneData,
                     tables: PacketTables, wave: bool = False,
                     normals: bool = False):
    """Spheres first (:func:`sphere_pass`), then the BVH seeded with the
    sphere distance (a triangle wins only when closer by more than
    epsilon).  Returns (t, identifier, is_triangle), and with ``normals``
    a fourth output from the traversal: the hit triangle's unnormalised
    cross(e1, e2), zero where no triangle won."""
    t_sph, sph_id = sphere_pass(origin, direction, scene)
    t, tri_id, *nrm = closest_hit_packets(origin, direction, tables,
                                          t_init=t_sph, wave=wave,
                                          normals=normals)
    is_tri = tri_id >= 0
    return (t, torch.where(is_tri, tri_id, sph_id), is_tri, *nrm)


# --------------------------------------------------------------------------
# environment map
# --------------------------------------------------------------------------

def _env_uv(d):
    """Equirectangular (u, v) of directions ``d`` [N, 3]: z up, u wraps in
    azimuth, v = 0 at the zenith."""
    u = torch.atan2(d[:, 1], d[:, 0]) * (0.5 * INV_PI) + 0.5
    v = torch.acos(torch.clamp(d[:, 2], -1.0, 1.0)) * INV_PI
    return u, v


def _env_nearest_index(scene: SceneData, u, v):
    """env_data row of the texel nearest to (u, v)."""
    eh, ew = int(scene.env_meta[0]), int(scene.env_meta[1])
    x = torch.clamp((u * ew).to(torch.int32), max=ew - 1)
    y = torch.clamp((v * eh).to(torch.int32), max=eh - 1)
    return torch.clamp(1 + y * ew + x, 0,
                       scene.env_data.shape[0] - 1).long()


def _sample_envmap(scene: SceneData, d, filter_mode: str):
    """Environment radiance [N, 3] for directions ``d``: one nearest tap
    under "nearest", four bilinear taps otherwise (u wraps, v clamps at
    the poles) into env_data's rows (offset 1; row 0 a fallback)."""
    eh, ew = int(scene.env_meta[0]), int(scene.env_meta[1])
    u, v = _env_uv(d)
    if filter_mode == "nearest":
        return scene.env_data[_env_nearest_index(scene, u, v)][:, :3]
    n_rows = scene.env_data.shape[0]

    def tap(xi, yi):
        yi = torch.clamp(yi, 0, eh - 1)
        idx = torch.clamp(1 + yi * ew + xi, 0, n_rows - 1).long()
        return scene.env_data[idx][:, :3]

    fx = u * ew - 0.5
    fy = v * eh - 0.5
    x0f = torch.floor(fx)
    y0f = torch.floor(fy)
    ax = _col(fx - x0f)
    ay = _col(fy - y0f)
    x0 = torch.remainder(x0f.to(torch.int32), ew)
    y0 = y0f.to(torch.int32)
    x1 = torch.remainder(x0 + 1, ew)
    return (tap(x0, y0) * (1 - ax) * (1 - ay) + tap(x1, y0) * ax * (1 - ay)
            + tap(x0, y0 + 1) * (1 - ax) * ay
            + tap(x1, y0 + 1) * ax * ay)


def _env_pdf_nearest(scene: SceneData, d):
    """The environment sampler's solid-angle pdf (env_data lane 3) of the
    texel nearest to ``d``: the pdf the alias draw used, so the MIS
    weights of both strategies sum to 1."""
    u, v = _env_uv(d)
    return scene.env_data[_env_nearest_index(scene, u, v)][:, 3]


# --------------------------------------------------------------------------
# textures
# --------------------------------------------------------------------------

def _tap_rows(table, idx):
    """Rows ``idx`` [N] (int32) of ``table``: one row gather.  On the
    H100 ``index_select`` and ``table[idx]`` take the same time, on int32
    or int64 indices."""
    return torch.index_select(table, 0, idx)


def _meta_select(texid, meta, lanes, level=None):
    """Per-ray values [N] of ``tex_meta`` lanes (or, with ``level`` [N],
    of a mip level's (offset, height, width) lanes) as one select chain
    over the static tuple: no gather and no host read of a device value.
    Returns one tensor a lane."""
    def entries():
        for k, m in enumerate(meta):
            if level is None:
                yield k, None, m
            else:
                for j, lm in enumerate(m[5]):
                    yield k, j, lm
    chain = list(entries())
    outs = [torch.full_like(texid, int(chain[0][2][lane])) for lane in lanes]
    for k, j, m in chain[1:]:
        sel = texid == k
        if j is not None:
            sel = sel & (level == j)
        outs = [torch.where(sel, int(m[lane]), o) for lane, o in zip(lanes,
                                                                     outs)]
    return outs


def _sample_texture(scene: SceneData, texid, u, v, filter_mode: str,
                    channels: int = 3, uv_fp=None):
    """Texels of the atlas at (u, v) [N] (v = 0 at the image's bottom) for
    texture ids ``texid`` [N] (-1: untextured, which taps row 0): one row
    gather of ``tex_data`` a tap, 1 under "nearest", 4 under "bilinear",
    8 under "trilinear" with the ray-cone footprint ``uv_fp`` = (u, v)
    footprints (two mip levels blended by the lod's fraction).  The wrap
    modes (0 repeat, 1 clamp to edge, 2 mirrored repeat) come from the
    static meta; a non-repeat border clamps the bilinear neighbour.
    ``channels=4`` also returns the cutout alpha of the same rows."""
    meta = scene.tex_meta
    # wrap modes: static over the meta, so a repeat-only scene issues no
    # wrap op
    any_wrap = any(len(m) > 3 and (m[3] or m[4]) for m in meta)
    if any_wrap:
        off, th, tw, ws, wt = _meta_select(texid, meta, range(5))

        def wrap_coord(c, mode):
            rep = c - torch.floor(c)
            t2 = c - 2.0 * torch.floor(c * 0.5)
            mir = torch.where(t2 > 1.0, 2.0 - t2, t2)
            cl = torch.clamp(c, 0.0, 1.0)
            return torch.where(mode == 1, cl, torch.where(mode == 2, mir, rep))

        u = wrap_coord(u, ws)
        v = wrap_coord(v, wt)
    else:
        off, th, tw = _meta_select(texid, meta, range(3))
        u = u - torch.floor(u)
        v = v - torch.floor(v)
    n_rows = scene.tex_data.shape[0]
    textured = texid >= 0

    def tap(o, hh, ww, xi, yi):
        idx = o + (hh - 1 - yi) * ww + xi
        idx = torch.clamp(torch.where(textured, idx, 0), 0, n_rows - 1)
        return _tap_rows(scene.tex_data, idx)[:, :channels]

    if filter_mode == "nearest":
        x = torch.minimum((u * tw).to(torch.int32), tw - 1)
        y = torch.minimum((v * th).to(torch.int32), th - 1)
        return tap(off, th, tw, x, y)

    def bilin(off_l, th_l, tw_l):
        """Four half-texel centred taps of one level ``off_l`` of
        ``th_l`` x ``tw_l`` texels."""
        fx = u * tw_l - 0.5
        fy = v * th_l - 0.5
        x0f = torch.floor(fx)
        y0f = torch.floor(fy)
        ax = _col(fx - x0f)
        ay = _col(fy - y0f)
        x0 = torch.remainder(x0f.to(torch.int32), tw_l)
        y0 = torch.remainder(y0f.to(torch.int32), th_l)
        x1 = torch.remainder(x0 + 1, tw_l)
        y1 = torch.remainder(y0 + 1, th_l)
        if any_wrap:
            # a non-repeat border clamps the neighbour texel instead of
            # wrapping to the opposite edge
            x0c = torch.minimum(torch.clamp(x0f.to(torch.int32), min=0),
                                tw_l - 1)
            y0c = torch.minimum(torch.clamp(y0f.to(torch.int32), min=0),
                                th_l - 1)
            x0 = torch.where(ws == 0, x0, x0c)
            y0 = torch.where(wt == 0, y0, y0c)
            x1 = torch.where(ws == 0, x1, torch.minimum(x0c + 1, tw_l - 1))
            y1 = torch.where(wt == 0, y1, torch.minimum(y0c + 1, th_l - 1))
        return (tap(off_l, th_l, tw_l, x0, y0) * (1 - ax) * (1 - ay)
                + tap(off_l, th_l, tw_l, x1, y0) * ax * (1 - ay)
                + tap(off_l, th_l, tw_l, x0, y1) * (1 - ax) * ay
                + tap(off_l, th_l, tw_l, x1, y1) * ax * ay)

    if filter_mode == "trilinear" and uv_fp is not None \
            and len(meta) > 0 and len(meta[0]) > 5:
        # the lod from the footprint in this texture's own texels, two
        # bilinear levels blended by its fraction; the levels' offsets
        # and sizes are static (the pack's mip chains)
        fpu, fpv = uv_fp
        fp_texels = torch.maximum(fpu * tw.to(torch.float32),
                                  fpv * th.to(torch.float32))
        nlev = torch.full_like(texid, len(meta[0][5]))
        for k in range(1, len(meta)):
            nlev = torch.where(texid == k, len(meta[k][5]), nlev)
        lod = torch.log2(torch.clamp(fp_texels, min=1.0))
        lod = torch.minimum(torch.clamp(lod, min=0.0),
                            (nlev - 1).to(torch.float32))
        l0 = lod.to(torch.int32)
        frac = _col(lod - l0.to(torch.float32))

        c0 = bilin(*_meta_select(texid, meta, range(3), l0))
        c1 = bilin(*_meta_select(texid, meta, range(3),
                                 torch.minimum(l0 + 1, nlev - 1)))
        return c0 * (1 - frac) + c1 * frac

    return bilin(off, th, tw)


# --------------------------------------------------------------------------
# fog: a slab z in [fog_z_min, fog_z_max] of density sigma exp(-falloff z)
# --------------------------------------------------------------------------

def _fog_overlap(origin, direction, t_limit, z_min: float, z_max: float):
    """(t_enter, length) of the rays' overlap with the fog slab, clipped
    to [0, t_limit] (t_limit [N]); length 0 for a ray that never crosses
    it (the slab is convex: at most one crossing)."""
    oz, dz = origin[:, 2], direction[:, 2]
    tiny = 1e-12
    parallel = torch.abs(dz) < tiny
    safe_dz = torch.where(parallel, tiny, dz)
    t0 = (z_min - oz) / safe_dz
    t1 = (z_max - oz) / safe_dz
    ta = torch.minimum(t0, t1)
    tb = torch.maximum(t0, t1)
    inside = (oz >= z_min) & (oz <= z_max)
    zero = torch.zeros_like(oz)
    far = torch.full_like(oz, VERY_FAR)
    ta = torch.where(parallel, torch.where(inside, zero, far), ta)
    tb = torch.where(parallel, torch.where(inside, far, zero), tb)
    ta = torch.clamp(ta, min=0.0)
    tb = torch.minimum(tb, t_limit)
    return ta, torch.clamp(tb - ta, min=0.0)


def _fog_density_coeffs(origin, direction, t_start, falloff: float):
    """(rho0, k) of the density along a segment from ``t_start``:
    density(s) = rho0 exp(-k s) with rho0 = exp(-falloff z_start) (its
    exponent clamped to +-60, which RenderConfig keeps exact) and
    k = falloff dz."""
    z_start = origin[:, 2] + direction[:, 2] * t_start
    rho0 = torch.exp(torch.clamp(-falloff * z_start, -60.0, 60.0))
    return rho0, falloff * direction[:, 2]


def _fog_optical_depth(sigma_t: float, rho0, k, s):
    """Optical depth over a segment of length ``s``: sigma_t rho0
    (1 - exp(-k s)) / k, and sigma_t rho0 s as k -> 0."""
    tiny = torch.abs(k) < 1e-12
    k_safe = torch.where(tiny, 1.0, k)
    ratio = torch.where(tiny, s, -torch.expm1(-k_safe * s) / k_safe)
    return sigma_t * rho0 * ratio


def _fog_free_flight(u, sigma_t: float, rho0, k):
    """The collision distance whose optical depth is -log(1 - u) (the
    inverse free-flight CDF of the height fog); VERY_FAR where the ray
    climbs out of the fog before that depth accrues."""
    e = -torch.log1p(-torch.clamp(u, max=1.0 - 1e-7))
    tiny = torch.abs(k) < 1e-12
    k_safe = torch.where(tiny, 1.0, k)
    g = e * k_safe / (sigma_t * rho0)
    s_het = -torch.log1p(-torch.clamp(g, max=1.0 - 1e-12)) / k_safe
    s = torch.where(tiny, e / (sigma_t * rho0), s_het)
    return torch.where(~tiny & (g >= 1.0), VERY_FAR, s)


def _fog_on(cfg: RenderConfig) -> bool:
    return cfg.fog == "on" and (cfg.fog_sigma_s + cfg.fog_sigma_a) > 0.0


def _shade_fog_sample(cfg: RenderConfig, rays, t, frame, slot, sob1=None,
                      row_offset: int = 0):
    """One free-flight draw a segment against its slab overlap: a
    collision before the surface makes the segment's event a medium event
    at t = t_enter + s.  Conditioning on no collision cancels the
    transmittance, so the surface and sky branches take no weight; the
    scattering albedo is applied through the throughput's colour
    multiply.  ``sob1``: the Sobol draws (:func:`_sobol_draws`), whose
    purpose 9 replaces the side stream.  Returns (t, is_fog)."""
    d = rays["direction"]
    f_sigma_t = cfg.fog_sigma_s + cfg.fog_sigma_a
    f_ta, f_len = _fog_overlap(rays["origin"], d, t, cfg.fog_z_min,
                               cfg.fog_z_max)
    if sob1 is not None:
        u_f = sob1(9)
    else:
        # side stream: the fog-off streams stay untouched
        _, u_f = rng.random_float(
            rng.seed_from(frame, rays["pixel"], slot, row_offset, 0xF06))
    if cfg.fog_falloff:
        f_rho0, f_k = _fog_density_coeffs(rays["origin"], d, f_ta,
                                          cfg.fog_falloff)
        f_s = _fog_free_flight(u_f, f_sigma_t, f_rho0, f_k)
    else:
        f_s = -torch.log1p(-torch.clamp(u_f, max=1.0 - 1e-7)) / f_sigma_t
    is_fog = f_s < f_len
    return torch.where(is_fog, f_ta + f_s, t), is_fog


# --------------------------------------------------------------------------
# shade
# --------------------------------------------------------------------------

def _col(x):
    return x[:, None]


def _light_power_mode(cfg: RenderConfig, scene: SceneData,
                      n_total: int) -> bool:
    """Whether the light pick is power-proportional: the one gate the NEE
    pick and the MIS emitter-hit pdf share (they must agree, or the MIS
    weights stop summing to 1).  Static: the config and the light count;
    a zero total power falls back to uniform at both sites alike."""
    return (cfg.light_sampling == "power" and n_total > 1
            and scene.light_powers.shape[0] == n_total)


def _n_lights(scene: SceneData) -> tuple[bool, int]:
    """(several lights, their count): the emissive spheres, triangles and
    delta lights; one sphere light or none is the single-light path."""
    total = len(scene.light_indices) + scene.n_tri_lights \
        + scene.n_delta_lights
    return (len(scene.light_indices) > 1 or scene.n_tri_lights > 0
            or scene.n_delta_lights > 0), total


def _attr_fetch(scene: SceneData, tid, p):
    """The tri_attr row of each hit triangle (one gather, shared by smooth
    normals and every map) and the barycentrics (bu, bv) of the
    (pre-offset) hit point ``p`` from its dual basis, with two dots."""
    arow = scene.tri_attr[tid]  # [N, 32]
    p_rel = p - arow[:, 0:3]
    return arow, dot(p_rel, arow[:, 3:6]), dot(p_rel, arow[:, 6:9])


def _smooth_normal(arow, bu, bv, normal_tri):
    """The corner normals interpolated at (bu, bv) and renormalised;
    triangles without usable corner normals (flag lane 25 off) keep
    ``normal_tri``."""
    ns = arow[:, 16:19] + _col(bu) * arow[:, 19:22] + _col(bv) * arow[:, 22:25]
    nlen = torch.sqrt(torch.clamp(dot(ns, ns), min=1e-20))
    return torch.where(_col(arow[:, 25] > 0.5), ns / _col(nlen), normal_tri)


def _attr_uv(arow, bu, bv):
    """The texture coordinates [N, 2] interpolated at (bu, bv)."""
    return arow[:, 9:11] + _col(bu) * arow[:, 11:13] \
        + _col(bv) * arow[:, 13:15]


def _normal_mapped(scene: SceneData, arow, uv_t, normal_tri,
                   filter_mode: str, uv_fp=None):
    """The tangent-space normal map (attr lane 26) applied to the current
    shading normal: the uv tangent (27:30) orthonormalised against it,
    B = cross(N, T) times the handedness (30); rays without a map or with
    a degenerate tangent keep ``normal_tri``."""
    ntexid = arow[:, 26].to(torch.int32)
    nm = _sample_texture(scene, ntexid, uv_t[:, 0], uv_t[:, 1], filter_mode,
                         uv_fp=uv_fp)
    n_ts = nm * 2.0 - 1.0
    tang = arow[:, 27:30]
    t_o = tang - normal_tri * _col(dot(normal_tri, tang))
    t_len = torch.sqrt(torch.clamp(dot(t_o, t_o), min=1e-20))
    t_o = t_o / _col(t_len)
    b_o = cross(normal_tri, t_o) * arow[:, 30:31]
    n_p = t_o * n_ts[:, 0:1] + b_o * n_ts[:, 1:2] \
        + normal_tri * torch.clamp(n_ts[:, 2:3], min=0.0)
    n_p = n_p / _col(torch.sqrt(torch.clamp(dot(n_p, n_p), min=1e-20)))
    apply_nm = (ntexid >= 0) & (t_len > 1e-6)
    return torch.where(_col(apply_nm), n_p, normal_tri)


def _shade_surface_fetch(cfg: RenderConfig, scene: SceneData, rays, o,
                         t_safe, ident, is_tri, hit, frame, slot,
                         tri_normal=None, row_offset: int = 0):
    """Hit-surface data: sphere rows by index, triangle rows from the
    tri_shade table, and under the scene's gates one tri_attr row a ray
    for smooth normals and the texture stack (albedo times the triangle
    colour with its cutout alpha, the normal map composed after smooth
    normals, the rough map clamped to [0.03, 1], the metalness pick on its
    own stream).  Returns (is_sphere, srow, normal, refl_tri, color_tri,
    rough_tri, em_tri, cut_alpha, blend_tri): rough_tri is tri_shade lane
    7 (roughness, a REFR triangle's IOR or a LIGHT triangle's area),
    em_tri the untextured tri_shade colour (the power pick's emission),
    cut_alpha and blend_tri None unless the alpha and blend gates are on;
    refl_tri has the refl lane's blend and metal flags stripped.

    With the traversal's ``tri_normal`` (unnormalised cross(e1, e2)) on a
    ``tri_default_mat`` scene, the triangle side needs no gather: the
    normal is ``tri_normal`` normalised and the material the default one
    (DIFF, colour 1, roughness 0.3, as Python scalars)."""
    sid = torch.clamp(ident, 0, scene.sphere_table.shape[0] - 1).long()
    is_sphere = hit & ~is_tri
    srow = scene.sphere_table[sid]
    normal_sphere = (o - srow[:, 0:3]) / _col(srow[:, 3])
    cut_alpha = blend_tri = em_tri = None
    if tri_normal is not None and scene.tri_default_mat:
        nlen = torch.sqrt(torch.clamp(dot(tri_normal, tri_normal),
                                      min=1e-30))
        normal_tri = tri_normal / _col(torch.clamp(nlen, min=1e-30))
        refl_tri, color_tri, rough_tri = DIFF, 1.0, 0.3
    else:
        tid = torch.clamp(ident, 0, scene.tri_shade.shape[0] - 1).long()
        trow = scene.tri_shade[tid]
        normal_tri = trow[:, 0:3]
        refl_tri = trow[:, 3].to(torch.int32)
        if scene.has_metal_maps:
            # the metal flag rides the refl lane as +32
            metal_tri = refl_tri >= 32
            refl_tri = torch.where(metal_tri, refl_tri - 32, refl_tri)
        if scene.has_blend:
            # the stochastic-blend flag rides the refl lane as +16
            blend_tri = refl_tri >= 16
            refl_tri = torch.where(blend_tri, refl_tri - 16, refl_tri)
        color_tri = em_tri = trow[:, 4:7]
        rough_tri = trow[:, 7]
        maps = scene.has_textures or scene.has_normal_maps \
            or scene.has_rough_maps
        if maps or scene.smooth_normals:
            arow, bu, bv = _attr_fetch(scene, tid, o)
        if maps:
            uv_t = _attr_uv(arow, bu, bv)
            uv_fp = None
            if cfg.texture_filter == "trilinear" and scene.tex_meta \
                    and len(scene.tex_meta[0]) > 5:
                # the ray-cone footprint: a pixel subtends about 1.5/H
                # world units per unit distance, mapped through the
                # triangle's uv gradients (a bounce reuses its segment's
                # t, without the cone's growth terms)
                grad_u = arow[:, 3:6] * arow[:, 11:12] \
                    + arow[:, 6:9] * arow[:, 13:14]
                grad_v = arow[:, 3:6] * arow[:, 12:13] \
                    + arow[:, 6:9] * arow[:, 14:15]
                fp_world = t_safe * (1.5 / cfg.height)
                uv_fp = (fp_world * torch.sqrt(torch.clamp(
                             dot(grad_u, grad_u), min=1e-20)),
                         fp_world * torch.sqrt(torch.clamp(
                             dot(grad_v, grad_v), min=1e-20)))
        if scene.has_textures:
            # the albedo taps also return the cutout alpha when the scene
            # has one (the rows are fetched whole)
            texid = arow[:, 15].to(torch.int32)
            albedo = _sample_texture(
                scene, texid, uv_t[:, 0], uv_t[:, 1], cfg.texture_filter,
                channels=4 if scene.has_alpha_tex else 3, uv_fp=uv_fp)
            color_tri = color_tri * torch.where(_col(texid >= 0),
                                                albedo[:, :3], 1.0)
            if _prof.ON:
                _prof.defer("tex_hits", lambda: (hit & is_tri
                                                 & (texid >= 0)).sum())
            if scene.has_alpha_tex:
                cut_alpha = torch.where(texid >= 0, albedo[:, 3], 1.0)
        if scene.smooth_normals:
            normal_tri = _smooth_normal(arow, bu, bv, normal_tri)
        if scene.has_normal_maps:
            normal_tri = _normal_mapped(scene, arow, uv_t, normal_tri,
                                        cfg.texture_filter, uv_fp)
        if scene.has_rough_maps:
            # the red channel is the perceptual roughness, clamped as the
            # scalar one is on the host
            rtexid = arow[:, 31].to(torch.int32)
            rrow = _sample_texture(scene, rtexid, uv_t[:, 0], uv_t[:, 1],
                                   cfg.texture_filter, uv_fp=uv_fp)
            rough_tri = torch.where(rtexid >= 0,
                                    torch.clamp(rrow[:, 0], 0.03, 1.0),
                                    rough_tri)
            if scene.has_metal_maps:
                # metalness (channel 1 of the same rows): the GGX conductor
                # with that probability, else DIFF (glTF's linear mix of
                # the two lobes, evaluated stochastically), from a side
                # stream
                _, u_m = rng.random_float(
                    rng.seed_from(frame, rays["pixel"], slot, row_offset,
                                  0x4E7A1))
                m_tex = torch.where(rtexid >= 0, rrow[:, 1], 1.0)
                pick_ggx = metal_tri & (u_m < m_tex)
                refl_tri = torch.where(pick_ggx, GGX, torch.where(
                    metal_tri, DIFF, refl_tri))
    normal = torch.where(_col(is_sphere), normal_sphere, normal_tri)
    return (is_sphere, srow, normal, refl_tri, color_tri, rough_tri, em_tri,
            cut_alpha, blend_tri)


def _ggx_eval(normal, view, light_dir, alpha, f0):
    """Single-scatter GGX BRDF value f(v, l), [n, 3]: ``view`` and
    ``light_dir`` point away from the surface, ``f0`` is the conductor's
    reflectance at normal incidence (the surface colour).  Separable Smith
    G2 = G1(v) * G1(l), Schlick Fresnel."""
    h = normalize(view + light_dir)
    nv = dot(normal, view)
    nl = dot(normal, light_dir)
    hv = torch.clamp(dot(h, view), min=0.0)
    d_term = ggx_d_vec(normal, h, alpha)
    g_term = ggx_g1(nv, alpha) * ggx_g1(nl, alpha)
    fres = f0 + (1.0 - f0) * _col(torch.pow(1.0 - hv, 5.0))
    denom = torch.clamp(4.0 * torch.clamp(nv, min=0.0)
                        * torch.clamp(nl, min=0.0), min=1e-8)
    return fres * _col(d_term * g_term / denom)


def _shade_emitter_hit(cfg: RenderConfig, scene: SceneData, rays, d,
                       normal, t_safe, hit, refl, refl_tri, color_tri,
                       rough_tri, is_sphere, srow, em_tri, direct):
    """Emitter hits: the emission of the hit sphere or LIGHT triangle (two
    sided; a textured one emits its texel's colour, the power pick reads
    the untextured ``em_tri``).  Without MIS, collected on specular-born
    paths, and the throughput of diffuse-born ones stopped (NEE counted them); with MIS,
    every hit weighted by the balance heuristic between the pdf of the
    BSDF sample that made the ray and the NEE pdf of this emitter point,
    and the path stopped."""
    emission = srow[:, 7:10]
    if scene.n_tri_lights:
        emission = torch.where(_col(is_sphere), emission, torch.where(
            _col(refl_tri == LIGHT), color_tri, torch.zeros_like(color_tri)))
    is_light = hit & (refl == LIGHT)
    last_spec_in = rays["last_specular"]
    if cfg.mis != "on":
        color = torch.where(_col(is_light & last_spec_in), direct * emission,
                            torch.zeros_like(direct))
        direct = torch.where(_col(is_light & ~last_spec_in),
                             torch.zeros_like(direct), direct)
        return color, direct
    # delta lights are never hit, but they take pick probability from the
    # area lights: the hit-side pdf divides by the count the NEE pick used
    multi, total = _n_lights(scene)
    total_l = float(total) if multi else 1.0
    p_strat_light = 0.5  # the sun/light coin (env-NEE takes the sun slot)
    pdf_in = rays["bsdf_pdf"]
    # the face-forwarded normal: -dot(normal, d) is the emitter-side
    # cosine the NEE pdf uses
    cos_l_hit = torch.clamp(-dot(normal, d), min=1e-6)
    sph_area = 4.0 * PI * srow[:, 3] * srow[:, 3]
    area_hit = torch.where(is_sphere, sph_area, rough_tri)  # lane 7: area
    if _light_power_mode(cfg, scene, int(total_l)):
        # the pick pdf of the hit light, from the hit row with the power
        # table's float32 luminance x area
        em_base = srow[:, 7:10]
        if scene.n_tri_lights:
            em_base = torch.where(_col(is_sphere), em_base, em_tri)
        lum_hit = (float(LUM_RGB[0]) * em_base[:, 0]
                   + float(LUM_RGB[1]) * em_base[:, 1]
                   + float(LUM_RGB[2]) * em_base[:, 2])
        total_power = scene.light_total_power
        pick_p_hit = torch.where(
            total_power > 0,
            0.75 * lum_hit * area_hit / torch.clamp(total_power, min=1e-30)
            + 0.25 / total_l, torch.full_like(lum_hit, 1.0 / total_l))
    else:
        pick_p_hit = 1.0 / total_l
    p_hit_sa = (p_strat_light * pick_p_hit) * (t_safe * t_safe) \
        / torch.clamp(cos_l_hit * area_hit, min=1e-12)
    w_hit = torch.where(last_spec_in | (pdf_in <= 0.0),
                        torch.ones_like(pdf_in),
                        pdf_in / torch.clamp(pdf_in + p_hit_sa, min=1e-12))
    color = torch.where(_col(is_light), direct * emission * _col(w_hit),
                        torch.zeros_like(direct))
    direct = torch.where(_col(is_light), torch.zeros_like(direct), direct)
    return color, direct


def _pick_light(cfg: RenderConfig, scene: SceneData, lu, total: int):
    """The light pick from the uniform ``lu``: (pick [N] i32, 1/pick-pdf
    [N], or the float light count under a uniform pick).  Power picks
    use the CDF (up to 64 lights: one broadcast compare, the same
    integers as the JAX package's compare chain) or one alias row (the
    scaled uniform's fraction is the coin)."""
    if not _light_power_mode(cfg, scene, total):
        return torch.clamp((lu * total).to(torch.int32), max=total - 1), \
            float(total)
    if total > 64:
        i0 = torch.clamp((lu * total).to(torch.int32), max=total - 1)
        frac = lu * total - i0.to(torch.float32)
        arow = scene.light_alias[i0.long()]
        take_self = frac < arow[:, 0]
        pick = torch.where(take_self, i0, arow[:, 1].to(torch.int32))
        return pick, torch.where(take_self, arow[:, 2], arow[:, 3])
    pick = (lu[:, None] >= scene.light_cdf[None, :total - 1]).sum(
        1, dtype=torch.int32)
    return pick, scene.light_inv_pdf[pick.long()]


def _env_nee_sample(scene: SceneData, rays, frame, slot, sob2=None,
                    row_offset: int = 0):
    """One environment draw a ray (the sun slot of NEE under MIS): an
    alias row turns two uniforms into a texel whose radiance and
    solid-angle pdf ride the row, two more jitter the direction inside
    it (Sobol purposes 11 and 12 under ``sob2``).  Returns (direction
    [N, 3], radiance / pdf [N, 3], pdf [N])."""
    eh, ew = int(scene.env_meta[0]), int(scene.env_meta[1])
    n_tx = eh * ew
    if sob2 is not None:
        eu1, eu2 = sob2(11)
        ej1, ej2 = sob2(12)
    else:
        es = rng.seed_from(frame, rays["pixel"], slot, row_offset, 0xE571)
        es, eu1 = rng.random_float(es)
        es, eu2 = rng.random_float(es)
        es, ej1 = rng.random_float(es)
        _, ej2 = rng.random_float(es)
    ei = torch.clamp((eu1 * n_tx).to(torch.int32), max=n_tx - 1)
    erow = scene.env_alias[ei.long()]
    ekeep = eu2 < erow[:, 0]
    ek = torch.where(ekeep, ei, erow[:, 1].to(torch.int32))
    e_rgb = torch.where(_col(ekeep), erow[:, 2:5], erow[:, 6:9])
    e_pdf = torch.where(ekeep, erow[:, 5], erow[:, 9])
    er = torch.div(ek, ew, rounding_mode="floor").to(torch.float32)
    ec = torch.remainder(ek, ew).to(torch.float32)
    eth = (er + ej1) * (PI / eh)
    eph = ((ec + ej2) / ew - 0.5) * (2.0 * PI)
    sin_th = torch.sin(eth)
    sample = torch.stack([sin_th * torch.cos(eph), sin_th * torch.sin(eph),
                          torch.cos(eth)], dim=-1)
    return sample, e_rgb / _col(torch.clamp(e_pdf, min=1e-12)), e_pdf


def _shade_nee_samples(cfg: RenderConfig, scene: SceneData,
                       sky_params: skymod.SkyParams, sun_dir, rays, o,
                       normal, frame, slot, seed, sob=None,
                       row_offset: int = 0):
    """The NEE samples: the sun-cone sample (or, with an envmap under MIS,
    the environment draw; with an envmap without MIS, none: the light
    takes every NEE sample), the 50/50 strategy coin, and the light pick
    (several spheres, emissive triangles with their two-sided normal,
    delta lights) with its surface sample and geometry factors.  Under
    ``sob`` = (sob1, sob2) the Sobol purposes 2 (cone), 3 (coin), 4
    (pick) and 5 (light point) replace the xorshift draws.  Returns a
    dict of what the estimators read."""
    sob1, sob2 = sob or (None, None)
    n = o.shape[0]
    mis = cfg.mis == "on"
    env_nee = mis and scene.has_envmap
    nee = dict(sun_radiance_env=None, e_pdf=None)
    if env_nee:
        sun_sample, nee["sun_radiance_env"], nee["e_pdf"] = \
            _env_nee_sample(scene, rays, frame, slot, sob2, row_offset)
    elif scene.has_envmap:
        sun_sample = sun_dir.expand(n, 3)  # no analytic sun under an envmap
    elif sob2 is not None:
        sun_sample = cone_sample_from_uniforms(
            sun_dir.expand(n, 3),
            1.0 - sky_params.sun_angular_diameter_cos, *sob2(2))
    else:
        sun_extent = 1.0 - sky_params.sun_angular_diameter_cos
        seed, sun_sample = cone_sample(sun_dir.expand(n, 3), sun_extent,
                                       seed)
    sun_cos = dot(normal, sun_sample)
    if sob1 is not None:
        cs_u = sob1(3)
    else:
        # side stream: the coin leaves the main shade stream untouched
        _, cs_u = rng.random_float(
            rng.seed_from(frame, rays["pixel"], slot, row_offset, 0xC0F1))
    choose_sun = cs_u < 0.5
    inv_p_sun = inv_p_light = 2.0
    if scene.has_envmap and not env_nee:
        # every NEE sample goes to the lights; the envmap arrives through
        # BSDF rays
        choose_sun = torch.zeros_like(choose_sun)
        inv_p_light = 1.0

    lights = scene.light_indices
    n_tri_l, n_delta = scene.n_tri_lights, scene.n_delta_lights
    multi, total = _n_lights(scene)
    has_light = True if multi else scene.light_index >= 0
    pick = None
    if multi:
        # one light a ray from a side stream (single-light scenes keep
        # their streams), one uniform pair for whichever shape it picked
        if sob1 is not None:
            lu = sob1(4)
        else:
            _, lu = rng.random_float(
                rng.seed_from(frame, rays["pixel"], slot, row_offset,
                              0x11F7))
        pick, n_lights = _pick_light(cfg, scene, lu, total)
        if scene.n_spheres == 0:
            # only triangle and delta lights: inert stand-ins (radius 1
            # avoids a masked /0), every sphere pick masked off below
            light_c = torch.zeros((n, 3), dtype=o.dtype, device=o.device)
            light_r = torch.ones((n,), dtype=o.dtype, device=o.device)
            light_e = torch.zeros((n, 3), dtype=o.dtype, device=o.device)
        else:
            base = lights[0] if lights else 0
            light_c = scene.sphere_center[base].expand(n, 3)
            light_r = scene.sphere_radius[base].expand(n)
            light_e = scene.sphere_emission[base].expand(n, 3)
        for k in range(1, len(lights)):
            sel = pick == k
            light_c = torch.where(_col(sel), scene.sphere_center[lights[k]],
                                  light_c)
            light_r = torch.where(sel, scene.sphere_radius[lights[k]],
                                  light_r)
            light_e = torch.where(_col(sel),
                                  scene.sphere_emission[lights[k]], light_e)
        if sob2 is not None:
            lu1, lu2 = sob2(5)
        else:
            seed, lu1 = rng.random_float(seed)
            seed, lu2 = rng.random_float(seed)
        lp = sphere_surface_from_uniforms(light_c, _col(light_r), lu1, lu2)
        n_l = normalize(lp - light_c)
        area = 4.0 * PI * light_r * light_r
        if n_tri_l:
            tl = scene.tri_lights
            idx = torch.clamp(pick - len(lights), 0, tl.shape[0] - 1).long()
            row = tl[idx]  # [N, 13]
            lp_tri = triangle_sample_from_uniforms(
                row[:, 0:3], row[:, 3:6], row[:, 6:9], lu1, lu2)
            tn = cross(row[:, 3:6], row[:, 6:9])
            tn = tn / _col(torch.clamp(torch.sqrt(torch.clamp(
                dot(tn, tn), min=1e-30)), min=1e-30))
            is_tl = (pick >= len(lights)) & (pick < len(lights) + n_tri_l)
            lp = torch.where(_col(is_tl), lp_tri, lp)
            light_e = torch.where(_col(is_tl), row[:, 9:12], light_e)
            area = torch.where(is_tl, row[:, 12], area)
            # two-sided emitter: the light normal faces the shading point
            sgn = torch.sign(dot(tn, o - lp) + 1e-30)
            n_l = torch.where(_col(is_tl), tn * _col(sgn), n_l)
    else:
        if scene.n_spheres == 0:
            # no sphere and so no light: inert stand-ins keep the shapes and
            # the draws (radius 1 avoids a masked /0); has_light is False
            light_c = torch.zeros(3, dtype=o.dtype, device=o.device)
            light_r = torch.ones((), dtype=o.dtype, device=o.device)
            light_e = torch.zeros(3, dtype=o.dtype, device=o.device)
        else:
            li = max(scene.light_index, 0)
            light_c = scene.sphere_center[li]
            light_r = scene.sphere_radius[li]
            light_e = scene.sphere_emission[li]
        n_lights = 1.0
        if sob2 is not None:
            lp = sphere_surface_from_uniforms(light_c.expand(n, 3), light_r,
                                              *sob2(5))
        else:
            seed, lp = sphere_surface_sample(light_c.expand(n, 3), light_r,
                                             seed)
        n_l = normalize(lp - light_c)
        area = 4.0 * PI * light_r * light_r
    lvec = lp - o
    ldist2 = dot(lvec, lvec)
    ldist = torch.sqrt(torch.clamp(ldist2, min=1e-20))
    ldir = lvec / _col(ldist)
    cos_surf = dot(normal, ldir)
    cos_light = dot(n_l, -ldir)
    solid_angle = cos_light * area / torch.clamp(ldist2, min=1e-20)
    if n_delta:
        # a picked delta light replaces the area sample: light_e its
        # intensity and solid_angle 1/d^2 (directional: its irradiance and
        # 1), cos_light pinned to 1; a spot's smooth Hermite falloff
        # between cos_outer and cos_inner
        first = len(lights) + n_tri_l
        drow = scene.delta_lights[torch.clamp(pick - first, 0,
                                              n_delta - 1).long()]
        d_kind = drow[:, 0]
        d_axis = drow[:, 4:7]  # unit, light -> scene
        is_dl = pick >= first
        is_ddir = is_dl & (d_kind >= 2.0)
        dl_vec = drow[:, 1:4] - o
        dl_d2 = torch.clamp(dot(dl_vec, dl_vec), min=1e-12)
        dl_dist = torch.sqrt(dl_d2)
        dl_ldir = torch.where(_col(is_ddir), -d_axis, dl_vec / _col(dl_dist))
        cd = dot(d_axis, -dl_ldir)
        tt = torch.clamp((cd - drow[:, 11])
                         / torch.clamp(drow[:, 10] - drow[:, 11], min=1e-6),
                         0.0, 1.0)
        one = torch.ones_like(tt)
        fall = torch.where(d_kind == 1.0, tt * tt * (3.0 - 2.0 * tt), one)
        ldir = torch.where(_col(is_dl), dl_ldir, ldir)
        ldist = torch.where(is_dl, torch.where(
            is_ddir, torch.full_like(dl_dist, VERY_FAR), dl_dist), ldist)
        cos_surf = torch.where(is_dl, dot(normal, dl_ldir), cos_surf)
        cos_light = torch.where(is_dl, one, cos_light)
        solid_angle = torch.where(
            is_dl, torch.where(is_ddir, fall, fall / dl_d2), solid_angle)
        light_e = torch.where(_col(is_dl), drow[:, 7:10], light_e)
    nee.update(seed=seed, sun_sample=sun_sample, sun_cos=sun_cos,
               choose_sun=choose_sun, inv_p_sun=inv_p_sun,
               inv_p_light=inv_p_light, has_light=has_light, pick=pick,
               n_lights=n_lights, light_e=light_e, area=area, ldir=ldir,
               ldist=ldist, ldist2=ldist2, cos_surf=cos_surf,
               cos_light=cos_light, solid_angle=solid_angle)
    return nee


def _shade_nee_weights(cfg: RenderConfig, scene: SceneData,
                       sky_params: skymod.SkyParams, d, o, normal, direct,
                       hit, refl, sun_dir, nee, ggx=None, is_fog=None):
    """DIFF and PHONG NEE estimators, GGX's when ``ggx`` = (is_ggx, alpha,
    f0) is given and the fog medium's (the HG phase for the BRDF times
    cosine) at the medium events ``is_fog``, from the samples of
    :func:`_shade_nee_samples`; under MIS the NEE-side balance weights (a
    delta light's weight 1); under fog every shadow colour times the slab
    transmittance along its segment from ``o``.  Returns the shadow-queue
    fields, the reflection vector the PHONG bounce reuses, the DIFF/PHONG
    masks, the BSDF pdf toward a direction (the bounce's MIS pdf) and the
    sun strategy's solid-angle pdf (the miss path's MIS weight; None
    without MIS)."""
    eps = cfg.epsilon
    mis = cfg.mis == "on"
    env_nee = mis and scene.has_envmap
    sun_sample, sun_cos = nee["sun_sample"], nee["sun_cos"]
    choose_sun, has_light = nee["choose_sun"], nee["has_light"]
    inv_p_sun, inv_p_light = nee["inv_p_sun"], nee["inv_p_light"]
    n_lights, light_e = nee["n_lights"], nee["light_e"]
    ldir, ldist, cos_surf = nee["ldir"], nee["ldist"], nee["cos_surf"]
    cos_light, solid_angle = nee["cos_light"], nee["solid_angle"]
    if env_nee:
        sun_radiance = nee["sun_radiance_env"]
    elif scene.has_envmap:
        sun_radiance = torch.zeros_like(direct)
    else:
        sun_radiance = skymod.sun(sun_sample, sun_dir, sky_params)
    # the sun strategy's scales: the reference's baked 1e-5 solid angle;
    # the env draw is radiance over pdf already, so the true BRDF factors
    c_diff = INV_PI if env_nee else 1e-5
    c_spec = 1.0 if env_nee else 1e-5

    diff_sun_color = inv_p_sun * direct * sun_radiance \
        * _col(sun_cos * c_diff)
    diff_sun_ok = choose_sun & (sun_cos > 0)
    light_e2 = light_e if light_e.ndim == 2 else light_e[None]
    # 1/(strategy pdf x pick pdf): a float under a uniform pick, a column
    # under a power pick
    nl_col = inv_p_light * n_lights if isinstance(n_lights, float) \
        else _col(inv_p_light * n_lights)
    diff_light_color = light_e2 * nl_col * direct \
        * _col(solid_angle * INV_PI * cos_surf)
    diff_light_ok = ~choose_sun & (cos_surf > 0) & (cos_light > 0) & has_light

    pe = PHONG_EXPONENT
    w_refl = normalize(d - normal * _col(2.0 * dot(normal, d)))
    phong_cos_sun = dot(sun_sample, w_refl)
    phong_sun_color = inv_p_sun * direct * ((pe + 2.0) * 0.5 * INV_PI) \
        * sun_radiance * _col(sun_cos * torch.pow(
            torch.clamp(phong_cos_sun, min=0.0), pe) * c_spec)
    phong_sun_ok = choose_sun & (sun_cos > 0) & (phong_cos_sun > eps)
    phong_cos_l = dot(ldir, w_refl)
    phong_light_color = light_e2 * nl_col * direct \
        * _col(solid_angle * (pe + 2.0) * 0.5 * INV_PI
               * torch.pow(torch.clamp(phong_cos_l, min=0.0), pe) * cos_surf)
    phong_light_ok = ~choose_sun & (cos_surf > 0) & (cos_light > 0) \
        & (phong_cos_l > eps) & has_light

    is_diff = hit & (refl == DIFF)
    is_phong = hit & (refl == PHONG)
    shadow_ok = (is_diff & (diff_sun_ok | diff_light_ok)) \
        | (is_phong & (phong_sun_ok | phong_light_ok))
    sun_c = _col(choose_sun)
    shadow_dir = torch.where(sun_c, sun_sample, ldir)
    shadow_color = torch.where(
        _col(is_diff), torch.where(sun_c, diff_sun_color, diff_light_color),
        torch.where(sun_c, phong_sun_color, phong_light_color))
    if ggx is not None:
        # the same sun/light estimator shape with the microfacet BRDF
        # evaluated toward each sample
        is_ggx, ggx_alpha, f0 = ggx
        view = -d
        f_ggx_sun = _ggx_eval(normal, view, sun_sample, ggx_alpha, f0)
        ggx_sun_color = inv_p_sun * direct * sun_radiance * f_ggx_sun \
            * _col(sun_cos * c_spec)
        ggx_sun_ok = choose_sun & (sun_cos > 0)
        f_ggx_l = _ggx_eval(normal, view, ldir, ggx_alpha, f0)
        ggx_light_color = light_e2 * nl_col * direct * f_ggx_l \
            * _col(solid_angle * cos_surf)
        ggx_light_ok = ~choose_sun & (cos_surf > 0) & (cos_light > 0) \
            & has_light
        shadow_ok = shadow_ok | (is_ggx & (ggx_sun_ok | ggx_light_ok))
        shadow_color = torch.where(
            _col(is_ggx), torch.where(sun_c, ggx_sun_color, ggx_light_color),
            shadow_color)
    if is_fog is not None:
        # a medium event: the phase function replaces the BRDF times the
        # cosine; the sun strategy keeps the reference's radiance scale
        # (DIFF's sun_cos * 1e-5 stands for INV_PI * cos * C: C = pi 1e-5)
        fog_sun_color = inv_p_sun * direct * sun_radiance * _col(
            hg_phase(dot(d, sun_sample), cfg.fog_g)
            * (1.0 if env_nee else PI * 1e-5))
        fog_light_color = light_e2 * nl_col * direct * _col(
            solid_angle * hg_phase(dot(d, ldir), cfg.fog_g))
        fog_light_ok = ~choose_sun & (cos_light > 0) & has_light
        shadow_ok = torch.where(is_fog, choose_sun | fog_light_ok, shadow_ok)
        shadow_color = torch.where(
            _col(is_fog), torch.where(sun_c, fog_sun_color, fog_light_color),
            shadow_color)

    def bsdf_pdf_toward(ddir):
        """Solid-angle pdf of this vertex's BSDF sampler producing
        ``ddir`` (0 for delta BSDFs: their paths carry last_specular)."""
        c = dot(normal, ddir)
        zero = torch.zeros_like(c)
        p = torch.where(is_diff, torch.clamp(c, min=0.0) * INV_PI, zero)
        pc = torch.clamp(dot(ddir, w_refl), min=0.0)
        p = torch.where(is_phong,
                        (pe + 1.0) * 0.5 * INV_PI * torch.pow(pc, pe), p)
        if ggx is not None:
            view_l = -d
            h_l = normalize(view_l + ddir)
            nv_l = torch.clamp(dot(normal, view_l), min=1e-6)
            p_ggx = ggx_g1(nv_l, ggx_alpha) \
                * ggx_d_vec(normal, h_l, ggx_alpha) / (4.0 * nv_l)
            p = torch.where(is_ggx, p_ggx, p)
        if is_fog is not None:
            # the HG phase is its own solid-angle pdf
            p = torch.where(is_fog, hg_phase(dot(d, ddir), cfg.fog_g), p)
        return p

    p_sun_sa = None
    if mis:
        # NEE-side balance weights p_strategy / (p_strategy + p_bsdf); the
        # emitter-hit and miss sides apply the complementary ones
        if env_nee:
            p_sun_sa = nee["e_pdf"] * (1.0 / inv_p_sun)
        else:
            sun_extent = 1.0 - sky_params.sun_angular_diameter_cos
            p_sun_sa = (1.0 / inv_p_sun) / (2.0 * PI * sun_extent)
        w_nee_sun = p_sun_sa / torch.clamp(
            p_sun_sa + bsdf_pdf_toward(sun_sample), min=1e-12)
        p_l_sa = (1.0 / inv_p_light) / n_lights * nee["ldist2"] \
            / torch.clamp(cos_light * nee["area"], min=1e-12)
        w_nee_light = p_l_sa / torch.clamp(p_l_sa + bsdf_pdf_toward(ldir),
                                           min=1e-12)
        if scene.n_delta_lights:
            # a BSDF ray never hits a delta light: NEE alone, weight 1
            first = len(scene.light_indices) + scene.n_tri_lights
            w_nee_light = torch.where(nee["pick"] >= first,
                                      torch.ones_like(w_nee_light),
                                      w_nee_light)
        w_nee = torch.where(choose_sun, w_nee_sun, w_nee_light)
        shadow_color = shadow_color * _col(w_nee)
    # sun shadows use the ShadowQueue default max distance; triangle
    # lights are BVH geometry, so their shadow range stops a hair short of
    # the sampled point (sphere lights keep the reference's exact range)
    ldist_occ = ldist * (1.0 - 1e-3) if scene.n_tri_lights else ldist
    shadow_maxd = torch.where(choose_sun, torch.full_like(ldist, VERY_FAR),
                              ldist_occ)
    if is_fog is not None:
        # every connection pays the slab's transmittance along its shadow
        # segment (to the slab's exit for the sun, to the sampled point for
        # a light)
        sh_ta, sh_len = _fog_overlap(
            o, shadow_dir, torch.where(choose_sun, VERY_FAR, ldist),
            cfg.fog_z_min, cfg.fog_z_max)
        f_sigma_t = cfg.fog_sigma_s + cfg.fog_sigma_a
        if cfg.fog_falloff:
            s_rho0, s_k = _fog_density_coeffs(o, shadow_dir, sh_ta,
                                              cfg.fog_falloff)
            sh_tau = _fog_optical_depth(f_sigma_t, s_rho0, s_k, sh_len)
        else:
            sh_tau = f_sigma_t * sh_len
        shadow_color = shadow_color * _col(torch.exp(-sh_tau))
    return (shadow_ok, shadow_dir, shadow_color, shadow_maxd, w_refl,
            is_diff, is_phong, bsdf_pdf_toward, p_sun_sa)


def _defer_light_picks(scene: SceneData, nee, *samples_lights) -> None:
    """Leave the counters ``tri_light_picks`` and ``delta_light_picks``
    for the step's end: the slots whose NEE took the light strategy at a
    point that samples lights (one of the masks ``samples_lights``, None
    where a material is absent) and picked a lamp triangle or a delta
    light."""
    pick = nee["pick"]
    first = len(scene.light_indices)
    lit = functools.reduce(torch.logical_or, [m for m in samples_lights
                                               if m is not None])
    lit = lit & ~nee["choose_sun"]
    _prof.defer("tri_light_picks", lambda: (
        lit & (pick >= first) & (pick < first + scene.n_tri_lights)).sum())
    _prof.defer("delta_light_picks", lambda: (
        lit & (pick >= first + scene.n_tri_lights)).sum())


def _glass_eta(cfg: RenderConfig, scene: SceneData, rays, direct, hit,
               refl, is_tri, rough_tri, frame, slot, sob1=None,
               row_offset: int = 0):
    """The REFR index of refraction: the reference's 1.2, a REFR
    triangle's own IOR under ``has_var_ior``, and under ``cfg.dispersion``
    one wavelength channel per glass event.  Returns (eta, direct): eta a
    float when neither applies, else an [N] tensor.

    Dispersion: eta_c = eta * (1 + dispersion * (c - 1)) for c in {0:R,
    1:G, 2:B}.  A polychromatic path meeting glass collapses to a random
    channel (direct *= 3 * onehot(c), unbiased); a monochromatic path
    keeps its channel.  The channel comes from a side stream (Sobol
    purpose 13 under ``sob1``), so the main shade stream draws as without
    dispersion.  RREFR stays undispersed."""
    eta = 1.2
    if scene.has_var_ior:
        eta = torch.where(is_tri & (refl == REFR), rough_tri,
                          torch.full_like(rough_tri, 1.2))
    if cfg.dispersion:
        if sob1 is not None:
            u_w = sob1(13)
        else:
            _, u_w = rng.random_float(
                rng.seed_from(frame, rays["pixel"], slot, row_offset,
                              0xD15B))
        pick = torch.clamp((u_w * 3.0).to(torch.int32), max=2)
        pos = direct > 0
        poly = (pos[:, 0].to(torch.int32) + pos[:, 1].to(torch.int32)
                + pos[:, 2].to(torch.int32)) > 1
        chan = torch.where(poly, pick,
                           torch.argmax(direct, dim=1).to(torch.int32))
        at_glass = hit & (refl == REFR)
        eta_c = eta * (1.0 + cfg.dispersion * (chan.to(torch.float32) - 1.0))
        eta = torch.where(at_glass, eta_c, eta)
        onehot = (torch.arange(3, dtype=torch.int32, device=chan.device)[None]
                  == chan[:, None]).to(direct.dtype)
        direct = torch.where(_col(at_glass & poly), direct * 3.0 * onehot,
                             direct)
    return eta, direct


def _shade_bounce(cfg: RenderConfig, scene: SceneData, rays, d, o, normal,
                  direct, hit, refl, is_tri, is_sphere, srow, rough_tri,
                  outside, is_diff, is_phong, w_refl, obj_color, t_safe,
                  seed, frame, slot, ggx=None, bsdf_pdf_toward=None,
                  is_fog=None, is_pass=None, sob=None, row_offset: int = 0):
    """Bounce sampling: DIFF cosine hemisphere, SPEC mirror, REFR Fresnel/
    TIR/Beer-Lambert (per-triangle IOR, dispersion), PHONG lobe with
    rejection, and under the scene's flags the GGX VNDF lobe (``ggx`` =
    (is_ggx, alpha)), RREFR rough glass, the fog medium's HG lobe at the
    medium events ``is_fog`` and the cutout pass-throughs ``is_pass``
    (the ray goes on behind the surface with its history and pdf).  Under
    MIS (``bsdf_pdf_toward`` given) also the pdf of the sampled direction,
    0 for a delta-born ray (mirror and both glass branches).  Under
    ``sob`` = (sob1, sob2) the Sobol purposes 6 (the bounce pair, which
    DIFF, GGX and RREFR share), 7 (the glass coin), 10 (the HG bounce)
    and 13 (the dispersion channel) replace the xorshift draws; the PHONG
    rejection loop keeps its stream.  Returns (seed, new_dir, direct,
    new_last_spec, next_bsdf_pdf or None, origin_out)."""
    eps = cfg.epsilon
    sob1, sob2 = sob or (None, None)
    if sob2 is not None:
        b_u, b_v = sob2(6)
        diff_dir = cosine_hemisphere_from_uniforms(normal, b_u, b_v)
    else:
        seed, diff_dir = cosine_hemisphere_sample(normal, seed)
    diff_new_dir = torch.where(_col(rays["bounces"] < cfg.max_bounces),
                               diff_dir, d)
    spec_dir = reflect(d, normal)

    # REFR: Schlick Fresnel + TIR, the reference's reversed-IoR convention
    eta, direct = _glass_eta(cfg, scene, rays, direct, hit, refl, is_tri,
                             rough_tri, frame, slot, sob1, row_offset)
    one = torch.ones_like(t_safe)
    n1 = torch.where(outside, one * eta, one)
    n2 = torch.where(outside, one, one * eta)
    r0 = ((n1 - n2) / (n1 + n2)) ** 2
    cos_i = -dot(normal, d)
    nr = n2 / n1
    sin_t2 = nr * nr * (1.0 - cos_i * cos_i)
    tir = sin_t2 > 1.0
    fresnel = torch.where(tir, one, r0 + (1.0 - r0) * torch.pow(
        torch.clamp(1.0 - cos_i, min=0.0), 5.0))
    if sob1 is not None:
        fr = sob1(7)
    else:
        seed, fr = rng.random_float(seed)
    refr_reflects = fr < fresnel
    cos_t = torch.sqrt(torch.clamp(1.0 - sin_t2, min=0.0))
    refr_dir = _col(nr) * d + _col(nr * cos_i - cos_t) * normal
    refr_new_dir = torch.where(_col(refr_reflects), spec_dir, refr_dir)
    is_refr = hit & (refl == REFR)
    beer = torch.exp(-obj_color * _col(t_safe))  # Beer-Lambert inside glass
    direct = direct * torch.where(_col(is_refr & ~outside), beer,
                                  torch.ones_like(beer))

    # PHONG lobe with rejection resampling: 8 masked retries, then the
    # ideal reflection
    seed, cur = phong_lobe_sample(w_refl, PHONG_EXPONENT, seed)
    ok = dot(cur, normal) > eps
    for _ in range(8):
        seed, cand = phong_lobe_sample(w_refl, PHONG_EXPONENT, seed)
        take = ~ok & (dot(cand, normal) > eps)
        cur = torch.where(_col(take), cand, cur)
        ok = ok | take
    phong_dir = torch.where(_col(ok), cur, w_refl)

    new_dir = torch.where(_col(is_diff), diff_new_dir, d)
    new_dir = torch.where(_col(hit & (refl == SPEC)), spec_dir, new_dir)
    new_dir = torch.where(_col(is_refr), refr_new_dir, new_dir)
    new_dir = torch.where(_col(is_phong), phong_dir, new_dir)
    # LIGHT keeps its direction

    if ggx is not None:
        # VNDF-sampled half-vector from a side stream; the reflected
        # direction's weight is F(h.v) * G1(n.l), zero below the horizon
        is_ggx, ggx_alpha = ggx
        if sob2 is not None:
            gu1, gu2 = b_u, b_v
        else:
            gseed = rng.seed_from(frame, rays["pixel"], slot, row_offset,
                                  0x66C5)
            gseed, gu1 = rng.random_float(gseed)
            _, gu2 = rng.random_float(gseed)
        view = -d
        ggx_h = ggx_vndf_sample_from_uniforms(view, normal, ggx_alpha,
                                              gu1, gu2)
        ggx_dir = reflect(d, ggx_h)
        ggx_nl = dot(normal, ggx_dir)
        ggx_hv = torch.clamp(dot(ggx_h, view), min=0.0)
        ggx_f = obj_color + (1.0 - obj_color) * _col(torch.pow(1.0 - ggx_hv,
                                                               5.0))
        ggx_w = torch.where(_col(ggx_nl > eps),
                            ggx_f * _col(ggx_g1(ggx_nl, ggx_alpha)),
                            torch.zeros_like(ggx_f))
        new_dir = torch.where(_col(is_ggx), ggx_dir, new_dir)
        direct = direct * torch.where(_col(is_ggx), ggx_w,
                                      torch.ones_like(ggx_w))

    rr_transmit = None
    if scene.has_rrefr:
        # rough glass: the REFR Fresnel/TIR/refraction above through a
        # VNDF-sampled microfacet h, with the REFR coin; either lobe's
        # weight is G1(n.out), and a sideways sample gets 0.  Both lobes
        # are delta-born (no NEE), like smooth glass.
        is_rrefr = hit & (refl == RREFR)
        rr_rough = torch.where(is_sphere, srow[:, 11], rough_tri)
        rr_alpha = torch.clamp(rr_rough * rr_rough, 1e-4, 1.0)
        if sob2 is not None:
            ru1, ru2 = b_u, b_v
        else:
            rsd = rng.seed_from(frame, rays["pixel"], slot, row_offset,
                                0x4F61)
            rsd, ru1 = rng.random_float(rsd)
            _, ru2 = rng.random_float(rsd)
        rr_h = ggx_vndf_sample_from_uniforms(-d, normal, rr_alpha, ru1, ru2)
        cos_im = -dot(rr_h, d)
        sin_t2m = nr * nr * (1.0 - cos_im * cos_im)
        fres_m = torch.where(sin_t2m > 1.0, one, r0 + (1.0 - r0) * torch.pow(
            torch.clamp(1.0 - cos_im, min=0.0), 5.0))
        rr_reflects = fr < fres_m
        cos_tm = torch.sqrt(torch.clamp(1.0 - sin_t2m, min=0.0))
        rr_dir = torch.where(
            _col(rr_reflects), reflect(d, rr_h),
            _col(nr) * d + _col(nr * cos_im - cos_tm) * rr_h)
        out_cos = dot(normal, rr_dir)
        rr_valid = (cos_im > 0.0) & torch.where(rr_reflects, out_cos > eps,
                                                out_cos < -eps)
        rr_w = torch.where(rr_valid, ggx_g1(torch.abs(out_cos), rr_alpha),
                           torch.zeros_like(out_cos))
        new_dir = torch.where(_col(is_rrefr), rr_dir, new_dir)
        direct = direct * torch.where(_col(is_rrefr), _col(rr_w),
                                      torch.ones_like(direct))
        direct = direct * torch.where(_col(is_rrefr & ~outside), beer,
                                      torch.ones_like(beer))
        rr_transmit = is_rrefr & ~rr_reflects

    if is_fog is not None:
        # the medium event's bounce: the exact HG inverse CDF around the
        # incoming direction (pdf = phase: weight 1; the albedo came
        # through the colour multiply)
        if sob2 is not None:
            fu1, fu2 = sob2(10)
        else:
            fs = rng.seed_from(frame, rays["pixel"], slot, row_offset, 0xF09)
            fs, fu1 = rng.random_float(fs)
            _, fu2 = rng.random_float(fs)
        fog_dir = hg_sample_from_uniforms(d, cfg.fog_g, fu1, fu2)
        new_dir = torch.where(_col(is_fog), fog_dir, new_dir)

    new_last_spec = (hit & (refl == SPEC)) | (is_refr & refr_reflects)
    if scene.has_rrefr:
        new_last_spec = new_last_spec | is_rrefr
    if is_pass is not None:
        # a pass-through keeps the path's BSDF history
        new_last_spec = torch.where(is_pass, rays["last_specular"],
                                    new_last_spec)
    next_bsdf_pdf = None
    if bsdf_pdf_toward is not None:
        is_delta_born = new_last_spec | (is_refr & ~refr_reflects)
        next_bsdf_pdf = torch.where(
            is_delta_born, torch.zeros_like(t_safe),
            torch.clamp(bsdf_pdf_toward(new_dir), min=1e-8))
        if is_pass is not None:
            # and the pdf of the sample that made it
            next_bsdf_pdf = torch.where(is_pass, rays["bsdf_pdf"],
                                        next_bsdf_pdf)
    zero = torch.zeros_like(normal)
    origin_out = o \
        + torch.where(_col(is_refr & ~refr_reflects), -2.0 * eps * normal,
                      zero) \
        + torch.where(_col(is_phong), eps * w_refl, zero)
    if rr_transmit is not None:
        # transmitted rough-glass rays start behind the surface, like REFR
        origin_out = origin_out + torch.where(_col(rr_transmit),
                                              -2.0 * eps * normal, zero)
    if is_pass is not None:
        # step through the cutout surface (the face-forward offset would
        # hit it again)
        origin_out = origin_out + torch.where(_col(is_pass),
                                              -2.0 * eps * normal, zero)
    return seed, new_dir, direct, new_last_spec, next_bsdf_pdf, origin_out


def _sobol_draws(cfg: RenderConfig, rays, row_offset: int = 0):
    """(sob1, sob2): shade's Sobol draws, each of a purpose (the JAX
    package's numbers), at every ray's own sample index, keyed by (pixel,
    row offset, bounces * 16 + purpose, cfg.seed when set, 0x50B0): a
    path's k-th sample takes point k of one sequence a dimension.  The
    (pixel, row offset) part of the key is hashed once for all
    purposes."""
    s_idx = rays["sample_idx"]
    salt = (cfg.seed,) if cfg.seed else ()
    prefix = rng.seed_prefix(rays["pixel"], row_offset)
    dim = rays["bounces"] * 16

    def key(purpose):
        return rng.seed_from(dim + purpose, *salt, 0x50B0, prefix=prefix)

    return (lambda purpose: sobol.sample_1d(s_idx, key(purpose)),
            lambda purpose: sobol.sample_2d(s_idx, key(purpose)))


def _shade(cfg: RenderConfig, scene: SceneData, sky_params: skymod.SkyParams,
           sun_dir, rays, t, ident, is_tri, frame, tri_normal=None,
           row_offset: int = 0):
    """Shade every queue slot.  Returns (color, survive, next_rays,
    shadow).  Where ``kshade.variant`` picks a shade kernel for the call,
    ``kshade.run`` launches it (and counts ``shade_fused``, the slots it
    shaded); else :func:`_shade_plain`, their plain version."""
    kind = kshade.variant(cfg, scene, t.device)
    if kind is None:
        return _shade_plain(cfg, scene, sky_params, sun_dir, rays, t, ident,
                            is_tri, frame, tri_normal, row_offset)
    return kshade.run(kind, cfg, scene, sky_params, sun_dir, rays, t, ident,
                      is_tri, frame, tri_normal, row_offset)


def _shade_plain(cfg: RenderConfig, scene: SceneData,
                 sky_params: skymod.SkyParams, sun_dir, rays, t, ident,
                 is_tri, frame, tri_normal=None, row_offset: int = 0):
    """Shade every queue slot in plain PyTorch: every configuration, on
    any device.  Returns (color, survive, next_rays, shadow).
    ``row_offset``: the first image row of the strip the rays belong to,
    in every seed (0 for the whole frame).  ``tri_normal``: the
    traversal's hit normals, which a ``tri_default_mat`` scene shades
    from without the tri_shade gather (:func:`_shade_surface_fetch`).
    Under fog a segment may end in a
    medium event before its surface (pseudo-material FOG); a cutout hit
    below its alpha threshold (0.5, or a uniform on a blend triangle)
    passes through (PASS): no shading, no NEE, no colour.  With the tracer
    on, the ``fetch_end`` marker follows the surface fetch and ``nee_end``
    the next-event weights, and the counters ``tex_hits``, ``alpha_pass``,
    ``ggx_hits``, ``fog_events``, ``tri_light_picks`` and
    ``delta_light_picks`` are left for the step's end."""
    n = cfg.num_rays
    eps = cfg.epsilon
    d = rays["direction"]
    slot = torch.arange(n, dtype=torch.int64, device=d.device)

    sob = _sobol_draws(cfg, rays, row_offset) if cfg.sampler == "sobol" \
        else None
    fog_on = _fog_on(cfg)
    is_fog = None
    if fog_on:
        t, is_fog = _shade_fog_sample(cfg, rays, t, frame, slot,
                                      None if sob is None else sob[0],
                                      row_offset)
        if _prof.ON:
            _prof.defer("fog_events", lambda: is_fog.sum())

    hit = t < VERY_FAR
    t_safe = torch.where(hit, t, torch.zeros_like(t))
    o = rays["origin"] + d * _col(t_safe)

    (is_sphere, srow, normal, refl_tri, color_tri, rough_tri, em_tri,
     cut_alpha, blend_tri) = _shade_surface_fetch(
        cfg, scene, rays, o, t_safe, ident, is_tri, hit, frame, slot,
        tri_normal, row_offset)
    if _prof.ON:
        _prof.mark(d.device, _prof.FETCH_END)
    refl = torch.where(is_sphere, srow[:, 10].to(torch.int32), refl_tri)
    refl = torch.where(hit, refl, torch.full_like(refl, DIFF))
    obj_color = torch.where(_col(is_sphere), srow[:, 4:7], color_tri)

    if fog_on:
        # a medium event has no surface: the normal -d makes the
        # face-forward a no-op and backs the offset off along the ray; the
        # colour multiply is the scattering albedo
        is_sphere = is_sphere & ~is_fog
        normal = torch.where(_col(is_fog), -d, normal)
        refl = torch.where(is_fog, FOG, refl)
        obj_color = torch.where(
            _col(is_fog), cfg.fog_sigma_s / (cfg.fog_sigma_s
                                              + cfg.fog_sigma_a), obj_color)

    is_pass = None
    if scene.has_alpha_tex:
        # alpha cutout; shadow rays stay alpha-blind, as in the JAX package
        thresh = 0.5
        if scene.has_blend:
            # stochastic transparency: a blend hit shades with probability
            # alpha, from a side stream
            _, u_b = rng.random_float(
                rng.seed_from(frame, rays["pixel"], slot, row_offset,
                              0xB1E2D))
            thresh = torch.where(blend_tri,
                                 torch.clamp(u_b, 1e-6, 1.0 - 1e-6), 0.5)
        is_pass = hit & is_tri & (cut_alpha < thresh)
        if fog_on:
            is_pass = is_pass & ~is_fog
        refl = torch.where(is_pass, PASS, refl)
        if _prof.ON:
            _prof.defer("alpha_pass", lambda: is_pass.sum())

    # throughput *= color for materials except REFR/LIGHT (and RREFR,
    # coloured by Beer-Lambert, GGX, whose colour is its Fresnel F0, and
    # a pass-through)
    mul_mask = hit & (refl != REFR) & (refl != LIGHT)
    if scene.has_rrefr:
        mul_mask = mul_mask & (refl != RREFR)
    if is_pass is not None:
        mul_mask = mul_mask & (refl != PASS)
    ggx = None
    if scene.has_ggx:
        mul_mask = mul_mask & (refl != GGX)
        ggx_rough = torch.where(is_sphere, srow[:, 11], rough_tri)
        ggx = (hit & (refl == GGX), ggx_rough * ggx_rough)
        if _prof.ON:
            _prof.defer("ggx_hits", lambda: ggx[0].sum())
    direct = rays["direct"] * torch.where(_col(mul_mask), obj_color,
                                          torch.ones_like(obj_color))

    outside = dot(normal, d) < 0
    normal = torch.where(_col(outside), normal, -normal)
    o = o + normal * eps

    last_spec_in = rays["last_specular"]
    mis = cfg.mis == "on"
    color, direct = _shade_emitter_hit(
        cfg, scene, rays, d, normal, t_safe, hit, refl, refl_tri, color_tri,
        rough_tri, is_sphere, srow, em_tri, direct)

    seed = rng.seed_from(frame, rays["pixel"], slot, row_offset, 0x5ADE)
    nee = _shade_nee_samples(cfg, scene, sky_params, sun_dir, rays, o,
                             normal, frame, slot, seed, sob, row_offset)
    (shadow_ok, shadow_dir, shadow_color, shadow_maxd, w_refl, is_diff,
     is_phong, bsdf_pdf_toward, p_sun_sa) = _shade_nee_weights(
        cfg, scene, sky_params, d, o, normal, direct, hit, refl, sun_dir,
        nee, ggx=None if ggx is None else (*ggx, obj_color), is_fog=is_fog)
    if _prof.ON:
        _prof.mark(d.device, _prof.NEE_END)
        if nee["pick"] is not None:
            _defer_light_picks(scene, nee, is_diff, is_phong,
                               None if ggx is None else ggx[0], is_fog)
    seed, new_dir, direct, new_last_spec, next_bsdf_pdf, origin_out = \
        _shade_bounce(cfg, scene, rays, d, o, normal, direct, hit, refl,
                      is_tri, is_sphere, srow, rough_tri, outside, is_diff,
                      is_phong, w_refl, obj_color, t_safe, nee["seed"],
                      frame, slot, ggx=ggx,
                      bsdf_pdf_toward=bsdf_pdf_toward if mis else None,
                      is_fog=is_fog, is_pass=is_pass, sob=sob,
                      row_offset=row_offset)

    # Russian roulette
    p = torch.clamp(direct.amax(-1), max=1.0)
    if sob is not None:
        rr = sob[0](8)
    else:
        seed, rr = rng.random_float(seed)
    survive = hit & (rays["bounces"] < cfg.max_bounces) & (p > eps) & (rr <= p)
    if _prof.ON:
        _prof.defer("roulette_kills", lambda: (
            hit & (rays["bounces"] < cfg.max_bounces) & ~survive).sum())
    direct_out = torch.where(_col(survive),
                             direct / _col(torch.clamp(p, min=1e-20)), direct)

    # miss: the environment map, or the sky (the sun disc only for
    # specular-born rays, or under MIS balance-weighted inside its cone)
    if scene.has_envmap:
        miss_col = _sample_envmap(scene, d, cfg.texture_filter)
        if mis:
            # the reverse weight of the environment draw, at the nearest
            # texel's pdf; delta-born rays (pdf 0) keep weight 1
            pdf_in = rays["bsdf_pdf"]
            w_env = torch.where(
                last_spec_in | (pdf_in <= 0.0), torch.ones_like(pdf_in),
                pdf_in / torch.clamp(pdf_in + _env_pdf_nearest(scene, d)
                                     * (1.0 / nee["inv_p_sun"]), min=1e-12))
            miss_col = miss_col * _col(w_env)
    else:
        sky_v, sunsky_v = skymod.sky_and_sunsky(d, sun_dir, sky_params)
        if mis:
            pdf_in = rays["bsdf_pdf"]
            in_cone = dot(d, sun_dir) > sky_params.sun_angular_diameter_cos
            w_sun = torch.where(
                last_spec_in | ~in_cone | (pdf_in <= 0.0),
                torch.ones_like(pdf_in),
                pdf_in / torch.clamp(pdf_in + p_sun_sa, min=1e-12))
            miss_col = sky_v + _col(w_sun) * (sunsky_v - sky_v)
        else:
            miss_col = torch.where(_col(last_spec_in), sunsky_v, sky_v)
    color = color + torch.where(_col(hit), torch.zeros_like(color),
                                rays["direct"] * miss_col)

    next_rays = dict(origin=origin_out, direction=new_dir, direct=direct_out,
                     pixel=rays["pixel"], bounces=rays["bounces"] + 1,
                     last_specular=new_last_spec)
    if mis:
        next_rays["bsdf_pdf"] = next_bsdf_pdf
    if sob is not None:
        # a ray keeps its sample index for its whole path (the bounce
        # depth tells its dimensions apart)
        next_rays["sample_idx"] = rays["sample_idx"]
    shadow = dict(origin=o, direction=shadow_dir, color=shadow_color,
                  max_dist=shadow_maxd, valid=shadow_ok)
    return color, survive, next_rays, shadow


# --------------------------------------------------------------------------
# connect
# --------------------------------------------------------------------------

def _connect(scene: SceneData, shadow, tables: PacketTables,
             wave: bool = False):
    """Shadow rays: BVH any hit plus the sphere any hit
    ((t + eps) < max distance; none in a scene without spheres).  Returns
    the unoccluded contribution."""
    o, sdir = shadow["origin"], shadow["direction"]
    valid = shadow["valid"]
    maxd = torch.where(valid, shadow["max_dist"],
                       torch.zeros_like(shadow["max_dist"]))
    occluded = any_hit_packets(o, sdir, maxd, tables,
                               wave=wave)  # invalid: maxd 0
    if scene.n_spheres:
        occluded = kspheres.any_hit(o, sdir, scene.sphere_center,
                                    scene.sphere_radius, occluded,
                                    shadow["max_dist"], valid)
    if _prof.ON:
        _prof.defer("unoccluded", lambda: (valid & ~occluded).sum())
    return torch.where(_col(valid & ~occluded), shadow["color"],
                       torch.zeros_like(shadow["color"]))


# --------------------------------------------------------------------------
# AOV pass: noise-free feature buffers for the denoiser
# --------------------------------------------------------------------------

def aov_primaries(camera: CameraParams, cfg: RenderConfig):
    """The AOV pass's rays, one per pixel in scan order: (origin [P, 3],
    direction [P, 3]), contiguous, under ``cfg.projection`` (the
    orthographic camera's origins shifted off the pinhole).  Raygen
    subtracts the sub-pixel jitter from the integer coordinate, so pixel
    (x, y)'s samples are centred at (x - 0.5, y - 0.5), and these rays go
    through that point, with no lens sample."""
    w, h = cfg.width, cfg.height
    pix = torch.arange(w * h, dtype=torch.int32,
                       device=camera.position.device)
    x = (pix % w).to(torch.float32)
    y = (pix // w).to(torch.float32)
    ni = (x - 0.5) / w - 0.5
    nj = (h - (y - 0.5)) / h - 0.5
    d, o_off, _ = _primary_dirs(cfg, camera, ni, nj)
    o = camera.position[None].expand(w * h, 3) if o_off is None \
        else camera.position[None] + o_off
    return o.contiguous(), d.contiguous()


def render_aovs(scene: SceneData, camera: CameraParams, cfg: RenderConfig,
                tables: PacketTables) -> dict:
    """One deterministic primary-ray pass over :func:`aov_primaries`:
    {albedo [H, W, 3], normal [H, W, 3], depth [H, W]}, the guides of the
    à-trous denoiser, with the albedo texture and the smooth and mapped
    normals.  The normal faces the ray; misses give albedo 1, normal 0 and
    depth VERY_FAR."""
    w, h = cfg.width, cfg.height
    o, d = aov_primaries(camera, cfg)
    t, ident, is_tri = _intersect_scene(o, d, scene, tables,
                                        wave=_pick_wave(cfg))
    hit = t < VERY_FAR
    hp = o + d * _col(torch.where(hit, t, torch.zeros_like(t)))
    is_sphere = hit & ~is_tri
    srow = scene.sphere_table[
        torch.clamp(ident, 0, scene.sphere_table.shape[0] - 1).long()]
    tid = torch.clamp(ident, 0, scene.tri_shade.shape[0] - 1).long()
    trow = scene.tri_shade[tid]
    normal_tri = trow[:, 0:3]
    color_tri = trow[:, 4:7]
    if scene.has_textures or scene.smooth_normals or scene.has_normal_maps:
        arow, bu, bv = _attr_fetch(scene, tid, hp)
        # the maps as shade samples them, trilinear as bilinear (the pass
        # has no ray cone)
        filt = "bilinear" if cfg.texture_filter == "trilinear" \
            else cfg.texture_filter
        if scene.has_textures or scene.has_normal_maps:
            uv_t = _attr_uv(arow, bu, bv)
        if scene.has_textures:
            texid = arow[:, 15].to(torch.int32)
            alb = _sample_texture(scene, texid, uv_t[:, 0], uv_t[:, 1], filt)
            color_tri = color_tri * torch.where(_col(texid >= 0), alb, 1.0)
        if scene.smooth_normals:
            normal_tri = _smooth_normal(arow, bu, bv, normal_tri)
        if scene.has_normal_maps:
            normal_tri = _normal_mapped(scene, arow, uv_t, normal_tri, filt)
    normal = torch.where(_col(is_sphere), (hp - srow[:, 0:3]) / srow[:, 3:4],
                         normal_tri)
    normal = torch.where(_col(dot(normal, d) < 0), normal, -normal)
    normal = torch.where(_col(hit), normal, torch.zeros_like(normal))
    albedo = torch.where(_col(is_sphere), srow[:, 4:7], color_tri)
    albedo = torch.where(_col(hit), albedo, torch.ones_like(albedo))
    depth = torch.where(hit, t, torch.full_like(t, VERY_FAR))
    return dict(albedo=albedo.reshape(h, w, 3), normal=normal.reshape(h, w, 3),
                depth=depth.reshape(h, w))


# --------------------------------------------------------------------------
# the full step
# --------------------------------------------------------------------------

def compaction_sort_key(next_rays, survive, node_packed, sent: int):
    """Terminated rays sort first by pixel; survivors sort past the
    sentinel, octant-major, then by the 8^3 grid cell of the bounce
    origin."""
    root_lo = node_packed[0, 0:3]
    root_hi = node_packed[0, 3:6]
    span = torch.clamp(root_hi - root_lo, min=1e-3)
    g = _KEY_GRID
    # clamp before the integer cast: out-of-range float -> int casts are
    # undefined in C++ (XLA saturates), the clip that follows agrees
    q = torch.clamp((next_rays["origin"] - root_lo) / span * float(g),
                    0.0, g - 1.0).to(torch.int32)
    cell = (q[:, 0] * g + q[:, 1]) * g + q[:, 2]
    nneg = (next_rays["direction"] < 0).to(torch.int32)
    octant = nneg[:, 0] + 2 * nneg[:, 1] + 4 * nneg[:, 2]
    return torch.where(survive, sent + octant * (g ** 3) + cell,
                       next_rays["pixel"])


def merge_queue(cfg: RenderConfig, state: RenderState,
                camera: CameraParams, cam_prev: CameraParams | None = None,
                local_height: int | None = None, row_offset: int = 0
                ) -> dict:
    """The step's ray queue (raygen top-off): the tail slots
    [n - n_carried, n) keep the carried survivors, the front slots get
    fresh camera rays (of the row strip ``local_height``, ``row_offset``
    when given)."""
    n = cfg.num_rays
    gen = _raygen(cfg, camera, state.start_position,
                  _salted_frame(cfg, state.frame),
                  perm=state.pixel_perm if cfg.adaptive_sampling == "on"
                  else None, sample_base=state.sample_base,
                  cam_prev=cam_prev, local_height=local_height,
                  row_offset=row_offset)
    slot = torch.arange(n, dtype=torch.int64, device=state.accum.device)
    keep = slot >= (n - state.n_carried)

    def merge(car, new):
        return torch.where(keep[:, None] if new.ndim == 2 else keep, car, new)

    rays = {k: merge(getattr(state, k), gen[k])
            for k in ("origin", "direction", "direct", "pending", "pixel",
                      "bounces", "last_specular")}
    if cfg.mis == "on":
        # fresh primaries are specular-born (their pdf is not read);
        # carried rays keep the pdf of the sample that made them
        rays["bsdf_pdf"] = merge(state.bsdf_pdf, torch.ones_like(
            state.bsdf_pdf))
    if cfg.sampler == "sobol":
        rays["sample_idx"] = merge(state.sample_idx, gen["sample_idx"])
    return rays


def check_step(cfg: RenderConfig, state: RenderState,
               local_height: int | None = None) -> None:
    """Raise ValueError, as the JAX step does, for a crop window outside
    the frame, beside adaptive sampling or on a row strip, and for an
    adaptive step on a state without its visit order (an old checkpoint:
    raygen would send every fresh ray to pixel 0)."""
    adaptive = cfg.adaptive_sampling == "on"
    local_height = cfg.height if local_height is None else local_height
    if cfg.crop is not None:
        cx0, cy0, cw, ch = (int(v) for v in cfg.crop)
        if adaptive:
            raise ValueError("cfg.crop is incompatible with "
                             "adaptive_sampling='on'")
        if local_height != cfg.height:
            raise ValueError("cfg.crop is incompatible with the sharded "
                             "row-strip path")
        if not (0 <= cx0 and 0 <= cy0 and cw > 0 and ch > 0
                and cx0 + cw <= cfg.width and cy0 + ch <= cfg.height):
            raise ValueError(f"crop {cfg.crop} outside the "
                             f"{cfg.width}x{cfg.height} frame")
    p_local = cfg.width * local_height
    if adaptive and state.pixel_perm.shape[0] != p_local:
        raise ValueError(
            f"adaptive_sampling='on' but state.pixel_perm has "
            f"{state.pixel_perm.shape[0]} entries (expected "
            f"{p_local}); re-init with init_state(cfg) or load the "
            "checkpoint with adaptive off")


def render_step(state: RenderState, scene: SceneData, camera: CameraParams,
                sun_dir, *, cfg: RenderConfig, tables: PacketTables,
                sky_params: skymod.SkyParams | None = None,
                cam_prev: CameraParams | None = None,
                local_height: int | None = None,
                row_offset: int = 0) -> RenderState:
    """One wavefront iteration.  Updates ``state.accum`` (and
    ``state.moment2`` when it is tracked) in place and returns the next
    state.  ``cam_prev``: the previous pose, which motion blur lerps
    from.  ``local_height`` and ``row_offset``: the row strip the state
    renders (:func:`init_state` with the same ``local_height``), which
    moves its rays' image rows and enters every seed; None and 0 are the
    whole frame.  With the tracer on (:mod:`~tyrant_tpu_torch.utils.profiling`)
    a device marker opens each stage (raygen, extend, shade, connect,
    sort, accumulate) and one ends the step.  Under a ``torch.profiler``
    session, with the tracer on or off, each stage is a range of its
    name, so a trace splits the step's device time by stage.  The markers, and the step's counters
    after them, are kernels of their own, so a CUDA graph captured with
    the tracer on records them on every replay.  With it off the step
    launches neither."""
    check_step(cfg, state, local_height)
    sky_params = sky_params or skymod.SkyParams(cfg.sky)
    n = cfg.num_rays
    total = _scan_total(cfg, local_height)
    frame_s = _salted_frame(cfg, state.frame)
    dev = state.accum.device

    # 1. raygen top-off
    with _prof.stage(dev, 0):
        rays = merge_queue(cfg, state, camera, cam_prev, local_height,
                           row_offset)
        scanned = state.start_position + (n - state.n_carried)
        start_next = scanned % total
        # Sobol: the round-robin passes completed
        sample_base_next = (state.sample_base + scanned // total) \
            & 0xFFFFFFFF

    # 2. extend
    with _prof.stage(dev, 1):
        t, ident, is_tri, *tri_normal = _intersect_scene(
            rays["origin"], rays["direction"], scene, tables,
            wave=_pick_wave(cfg), normals=kernel_normals(cfg, scene))

    # 3. shade
    with _prof.stage(dev, 2):
        color, survive, next_rays, shadow = _shade(
            cfg, scene, sky_params, sun_dir, rays, t, ident, is_tri,
            frame_s, tri_normal=tri_normal[0] if tri_normal else None,
            row_offset=row_offset)

    # 4. connect
    with _prof.stage(dev, 3):
        shadow_contrib = _connect(scene, shadow, tables,
                                  wave=_pick_wave(cfg))

    # 5. one stable sort: compaction of survivors AND pixel order of the
    # terminated rays (shade's RNG is keyed by queue slot, so the order
    # must equal the JAX package's stable multi-operand sort)
    with _prof.stage(dev, 4):
        contrib = color + shadow_contrib
        if cfg.radiance_clamp > 0.0:
            # the firefly clamp on each bounce's contribution, per channel
            contrib = torch.clamp(contrib, max=cfg.radiance_clamp)
        pend = rays["pending"] + contrib
        sent = sentinel(state.accum.shape[0])
        key = compaction_sort_key(next_rays, survive, scene.bvh.node_packed,
                                  sent)
        # pixel (< 2^21) | bounces (<= 15) | lastSpecular in one column
        packed = (next_rays["pixel"] << 5) | (next_rays["bounces"] << 1) \
            | next_rays["last_specular"].to(torch.int32)
        key_s, order = torch.sort(key, stable=True)
        origin_s = next_rays["origin"][order]
        direction_s = next_rays["direction"][order]
        direct_s = next_rays["direct"][order]
        pend_s = pend[order]
        packed_s = packed[order]
        bsdf_pdf_s = next_rays["bsdf_pdf"][order] if cfg.mis == "on" \
            else state.bsdf_pdf
        sample_idx_s = next_rays["sample_idx"][order] \
            if cfg.sampler == "sobol" else state.sample_idx
        n_carried = survive.sum()

    # 6. flush the terminated rays' pending radiance (+1 path count),
    # straight from the sort: the keys below the sentinel; with the second
    # moments, their squares in the same launch
    with _prof.stage(dev, 5):
        if _moments(cfg):
            accum = accumulate_terminated(state.accum, key_s, pend_s,
                                          moment2=state.moment2)
        else:
            accum = accumulate_terminated(state.accum, key_s, pend_s)
    if _prof.ON:
        _prof.mark(dev, _prof.END)
    shadow_valid = shadow["valid"].sum()
    if _prof.ON:
        hits, tri_hits = (t < VERY_FAR).sum(), is_tri.sum()
        _prof.count(dev, fresh_rays=n - state.n_carried, tri_hits=tri_hits,
                    sphere_hits=hits - tri_hits, survivors=n_carried,
                    shadow_slots=n, shadow_valid=shadow_valid,
                    flushed=n - n_carried)

    return RenderState(
        accum=accum, origin=origin_s, direction=direction_s, direct=direct_s,
        pending=pend_s, pixel=packed_s >> 5, bounces=(packed_s >> 1) & 15,
        last_specular=(packed_s & 1).to(torch.bool), n_carried=n_carried,
        start_position=start_next, frame=(state.frame + 1) & 0xFFFFFFFF,
        shadow_rays=state.shadow_rays + shadow_valid,
        bsdf_pdf=bsdf_pdf_s, moment2=state.moment2,
        pixel_perm=state.pixel_perm, sample_base=sample_base_next,
        sample_idx=sample_idx_s)


def _camera_views(buf: torch.Tensor) -> CameraParams:
    """A camera whose fields are views of one 14-float buffer."""
    return CameraParams(position=buf[0:3], direction=buf[3:6],
                        right=buf[6:9], up=buf[9:12], focal_distance=buf[12],
                        lens_radius=buf[13])


class _Graph:
    """One captured CUDA graph, its static outputs, the kernel launches
    that each replay makes (the wrappers' counters, ``ops.kernels``) and
    the render steps it holds with the tracer's markers (``traced``: 0
    when captured with the tracer off)."""

    def __init__(self, fn, device, what: str, steps: int = 0):
        """Capture ``fn()``, which must read and write only tensors that
        outlive the graph and runs ``steps`` render steps.  The capture
        runs on its own side stream; the wrappers called in it launch
        nothing, so their counters are set back.  Raises when the capture
        fails: nothing falls back to eager launches."""
        self.traced = steps if _prof.ON else 0
        before = kernels.launch_counts()
        self.graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(self.graph):
                self.out = fn()
        except Exception as e:
            raise RuntimeError(
                f"capturing {what} into a CUDA graph failed "
                "(RenderConfig.fuse_step_chains='off' runs it eagerly)") from e
        finally:
            after = kernels.launch_counts()
            kernels.set_launch_counts(before)
        self.launches = {k: after[k] - before[k] for k in after
                         if after[k] != before[k]}


def _warm_up(fn, device):
    """``fn()`` once, eagerly, on a side stream: the recipe before a
    capture, so that no lazy set-up happens inside it."""
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        out = fn()
    torch.cuda.current_stream(device).wait_stream(side)
    return out


class Renderer:
    """Host-side wrapper: device upload, accumulation reset on camera or
    sun movement, framebuffer resolve with the optional denoiser and
    bloom.

    ``Renderer(scene, cfg).step(cam, n)`` runs the main path on the GPU
    through the CUDA kernels, and raises when there is no CUDA device;
    ``device="cpu"`` runs it with the kernels' plain versions.  ``scene``
    is a host :class:`Scene` or, with ``tables``, a :class:`SceneData`
    already on ``device``.

    ``cfg.fuse_step_chains`` "auto" or "on" on CUDA (the counterpart of
    the JAX package's fused, jitted step): the step, the AOV pass and
    ``image()`` each run as a captured CUDA graph, replayed, with the
    state, the camera and the sun in static buffers that a pose or sun
    change overwrites in place.  The first step runs eagerly as the
    capture's warm-up; a capture that fails raises.  "off", and every CPU
    renderer, run eagerly.  A replay adds nothing to the kernel wrappers'
    launch counters: ``replayed_steps`` counts the steps replayed and
    ``replayed_launches`` the kernel launches the replays made, by
    counter name (``ops.kernels.launch_counts``).

    With the tracer on (:mod:`~tyrant_tpu_torch.utils.profiling`, enabled
    before the first step), :meth:`step` records the host spans
    ``render.step`` with ``render.step.reset``, ``render.step.camera``,
    ``render.step.replay`` (the graph launch alone), ``render.step.eager``
    and, when the visit order is rebuilt, ``render.step.adapt``;
    :meth:`image` records ``render.image`` with ``render.image.replay`` or
    ``render.image.resolve``, and its resolve a device marker at each end.
    The graphs captured then hold the step's stage markers and counters.

    Under ``cfg.motion_blur`` the step lerps each fresh ray's pose from
    the previous distinct pose (captured: a second static camera buffer,
    filled from the current one on the device before a new pose lands).
    Under adaptive sampling the visit order is rebuilt every
    ``cfg.adaptive_interval`` steps after the steps
    (:func:`adaptive.build_perm`, into the state's ``pixel_perm``; the
    phase goes to the device from pinned memory, nothing is read back).
    :meth:`noise_estimate` needs the second moments
    (``track_variance`` or adaptive sampling)."""

    def __init__(self, scene, cfg: RenderConfig = RenderConfig(), *,
                 device="cuda", sun_position=(0.05, 0.3),
                 tables: PacketTables | None = None):
        self.cfg = cfg
        self.device = resolve(device)
        self.scene = scene.to_device(self.device) if isinstance(scene, Scene) \
            else scene
        self.tables = tables if tables is not None \
            else PacketTables(self.scene.bvh)
        if not self.tables.supported:
            raise ValueError("the scene's fat-row table is unsupported (over "
                             "2^24 rows or prims, or deeper than the "
                             "traversal stack)")
        self.sky_params = skymod.SkyParams(cfg.sky)
        self.sun_position = tuple(sun_position)
        self.sun_dir = skymod.sun_direction_from_position(self.sun_position,
                                                          self.device)
        self._last_pose = None
        self._last_cam: CameraParams | None = None  # for the AOV pass
        self._aov_cache = None  # (pose, aovs)
        self.state = init_state(cfg, self.device)
        self._blur = cfg.motion_blur > 0.0
        self._prev_cam: CameraParams | None = None  # motion blur, eager
        self._sched = adaptive_mod.PermScheduler(cfg.adaptive_interval) \
            if cfg.adaptive_sampling == "on" else None
        self.captured = self.device.type == "cuda" and (
            cfg.fuse_step_chains == "on" or cfg.fuse_step_chains == "auto")
        self.replayed_steps = 0
        self.replayed_launches: dict[str, int] = {}
        self._graphs: dict = {}  # "step", "aov", ("image", denoise, uint8)
        if self.captured:
            # the static camera: one buffer, its fields are views
            self._cam_buf = torch.zeros(14, dtype=torch.float32,
                                        device=self.device)
            self._cam = _camera_views(self._cam_buf)
            self._cam_vec = None  # the values in the buffer
            # motion blur's previous pose, a second static buffer
            self._cam_prev_buf = torch.zeros_like(self._cam_buf)
            self._cam_prev = _camera_views(self._cam_prev_buf)

    def _reset(self):
        if self.captured:  # the graphs read these very tensors
            st = self.state
            for t in (st.accum, st.n_carried, st.moment2, st.sample_base):
                t.zero_()
            if st.pixel_perm.shape[0] > 1:
                st.pixel_perm.copy_(adaptive_mod.identity_perm(
                    st.pixel_perm.shape[0], self.device))
        else:
            self.state = reset_accumulation(self.state)

    def set_sun(self, sun_position):
        if tuple(sun_position) != self.sun_position:
            self.sun_position = tuple(sun_position)
            sun = skymod.sun_direction_from_position(self.sun_position,
                                                     self.device)
            if self.captured:
                self.sun_dir.copy_(sun)
            else:
                self.sun_dir = sun
            self._reset()

    def step(self, camera: Camera, n_steps: int = 1) -> RenderState:
        """``n_steps`` wavefront steps at ``camera``'s pose (a new pose
        resets the accumulation first); returns ``self.state``.  When the
        step is captured, that state's tensors are the graph's static
        buffers, which the next step or reset overwrites: copy what must
        outlive it."""
        with _prof.span("render.step") if _prof.ON else _prof.OFF:
            return self._step(camera, n_steps)

    def _step(self, camera: Camera, n_steps: int) -> RenderState:
        steps = n_steps
        pose = camera.pose_key()
        moved = self._last_pose is not None and pose != self._last_pose
        if moved:
            with _prof.span("render.step.reset") if _prof.ON else _prof.OFF:
                self._reset()
        self._last_pose = pose
        if not self.captured:
            cam = camera.to_device(self.cfg, self.device)
            if moved:
                # the pose just left opens the new frame's shutter
                self._prev_cam = self._last_cam
            self._last_cam = cam
            if self._prev_cam is None:
                self._prev_cam = cam  # the first frame: no motion yet
            with _prof.span("render.step.eager") if _prof.ON else _prof.OFF:
                for _ in range(n_steps):
                    self.state = self._render_step(self.state, cam,
                                                   self._prev_cam)
            self._adapt(n_steps)
            return self.state
        first = self._cam_vec is None
        if self._blur and moved:
            # in stream order, before the new pose's copy lands
            self._cam_prev_buf.copy_(self._cam_buf)
        with _prof.span("render.step.camera") if _prof.ON else _prof.OFF:
            self._set_camera(camera)
        if self._blur and first:
            self._cam_prev_buf.copy_(self._cam_buf)
        self._last_cam = self._cam
        if "step" not in self._graphs and n_steps:
            # one graph of one step: a replay costs microseconds, and on an
            # H100 a graph of four steps (the JAX package's _CHAIN_LEN) ran
            # no faster (chip_smoke.captured_step measures both)
            with _prof.span("render.step.eager") if _prof.ON else _prof.OFF:
                _warm_up(self._static_step, self.device)  # a real step
            self._graphs["step"] = _Graph(self._static_step, self.device,
                                          "the render step", steps=1)
            n_steps -= 1
        for _ in range(n_steps):
            self._replay(self._graphs["step"], "render.step.replay")
            self.replayed_steps += 1
        self._adapt(steps)  # the warm-up step counts
        return self.state

    def _adapt(self, n_steps: int) -> None:
        """Adaptive sampling: the visit order rebuilt when the scheduler
        says so, from the moments the steps left, into the state's
        ``pixel_perm`` (in place when captured: the graph reads it)."""
        if self._sched is None:
            return
        phase = self._sched.tick(n_steps)
        if phase is None:
            return
        with _prof.span("render.step.adapt") if _prof.ON else _prof.OFF:
            ph = torch.tensor(phase, dtype=torch.float32)
            if self.device.type == "cuda":
                ph = ph.pin_memory().to(self.device, non_blocking=True)
            perm = adaptive_mod.build_perm(self.state.accum,
                                           self.state.moment2, ph,
                                           gamma=self.cfg.adaptive_gamma)
            if self.captured:
                self.state.pixel_perm.copy_(perm)
            else:
                self.state = dataclasses.replace(self.state, pixel_perm=perm)

    def noise_estimate(self) -> float:
        """The image's convergence: the mean relative standard error of
        the per-pixel radiance means (:func:`adaptive.mean_relative_error`,
        read on the host).  Needs the second moments: raises without
        ``track_variance="on"`` or adaptive sampling."""
        if self.state.moment2.shape[0] == 1:
            raise RuntimeError(
                "noise_estimate() needs per-pixel second moments: set "
                "track_variance='on' (or adaptive_sampling='on')")
        return float(adaptive_mod.mean_relative_error(self.state.accum,
                                                      self.state.moment2))

    def _set_camera(self, camera: Camera):
        """The static camera's buffer from ``camera``: the values
        ``Camera.to_device`` gives, in one copy from pinned memory that
        does not wait for the device, made when they change."""
        right, up = camera.basis(self.cfg)
        vec = np.concatenate([np.asarray(x, np.float32).reshape(-1) for x in (
            camera.position, camera.direction, right, up,
            camera.focal_distance, camera.lens_radius)])
        if self._cam_vec is None or not np.array_equal(vec, self._cam_vec):
            self._cam_buf.copy_(torch.from_numpy(vec).pin_memory(),
                                non_blocking=True)
            self._cam_vec = vec

    def _render_step(self, state, cam, cam_prev=None):
        return render_step(state, self.scene, cam, self.sun_dir, cfg=self.cfg,
                           tables=self.tables, sky_params=self.sky_params,
                           cam_prev=cam_prev if self._blur else None)

    def _static_step(self):
        """One step on the static buffers: the new state is copied into
        them (the accumulation and the moments are updated in place
        already)."""
        new = self._render_step(self.state, self._cam, self._cam_prev)
        for f in dataclasses.fields(RenderState):
            dst, src = getattr(self.state, f.name), getattr(new, f.name)
            if dst is not src:
                dst.copy_(src)

    def _replay(self, g: _Graph, span: str | None = None):
        """Replay ``g``; with the tracer on, the host span ``span``, if
        given, around the launch alone."""
        with _prof.span(span) if _prof.ON and span else _prof.OFF:
            g.graph.replay()
        if g.traced and _prof.ON:
            _prof.replayed(self.device, g.traced)
        for k, v in g.launches.items():
            self.replayed_launches[k] = self.replayed_launches.get(k, 0) + v

    def _captured(self, key, fn, what: str) -> _Graph:
        """The graph of ``fn`` under ``key``, captured after a warm-up on
        first use."""
        g = self._graphs.get(key)
        if g is None:
            _warm_up(fn, self.device)
            g = self._graphs[key] = _Graph(fn, self.device, what)
        return g

    def radiance(self) -> torch.Tensor:
        """Linear HDR radiance mean [H, W, 3]."""
        counts = torch.clamp(self.state.accum[:, 3:4], min=1e-8)
        return (self.state.accum[:, :3] / counts).reshape(
            self.cfg.height, self.cfg.width, 3)

    def image(self, denoise: bool | None = None,
              uint8: bool = False) -> torch.Tensor:
        """Display image [H, W, 3] in [0, 1]: the radiance mean, denoised
        when ``denoise`` (default: ``cfg.denoise == "on"``) and a pose was
        stepped, then bloomed when ``cfg.bloom_strength > 0``, then tone
        mapped; with ``uint8``, ``to_uint8`` of it.  The accumulation
        buffer is untouched.  When the renderer is captured, this is a
        replay and the image the graph's static output, which the next
        call overwrites."""
        with _prof.span("render.image") if _prof.ON else _prof.OFF:
            use_dn = (self.cfg.denoise == "on") if denoise is None \
                else denoise
            use_dn = use_dn and self._last_cam is not None
            aovs = self._pose_aovs() if use_dn else None
            if not self.captured:
                with _prof.span("render.image.resolve") if _prof.ON \
                        else _prof.OFF:
                    return self._resolve(aovs, uint8)
            g = self._captured(("image", use_dn, uint8),
                               lambda: self._resolve(aovs, uint8), "image()")
            self._replay(g, "render.image.replay")
            return g.out

    def _resolve(self, aovs, uint8: bool) -> torch.Tensor:
        cfg = self.cfg
        if _prof.ON:
            _prof.mark(self.device, _prof.IMAGE)
        mean = self.radiance()
        if aovs is not None:
            mean = atrous_denoise(mean, aovs["albedo"], aovs["normal"],
                                  aovs["depth"],
                                  iterations=cfg.denoise_iterations)
        if cfg.bloom_strength > 0.0:
            mean = bloom(mean, cfg.bloom_strength, cfg.bloom_threshold,
                         cfg.bloom_radius)
        img = tonemap_image(mean, cfg.tonemap, cfg.exposure)
        img = to_uint8(img) if uint8 else img
        if _prof.ON:
            _prof.mark(self.device, _prof.IMAGE_END)
        return img

    def aovs(self) -> dict:
        """The AOV pass (:func:`render_aovs`) for the last stepped pose
        (when captured, static buffers that the next pose's pass
        overwrites)."""
        if self._last_cam is None:
            raise RuntimeError("step() once before requesting AOVs "
                               "(they are rendered for the last pose)")
        return self._pose_aovs()

    def _pose_aovs(self) -> dict:
        """The AOV pass, run once per camera pose."""
        if self._aov_cache is None or self._aov_cache[0] != self._last_pose:
            if self.captured:
                g = self._captured("aov", lambda: render_aovs(
                    self.scene, self._cam, self.cfg, self.tables),
                    "the AOV pass")
                self._replay(g)
                aovs = g.out
            else:
                aovs = render_aovs(self.scene, self._last_cam, self.cfg,
                                   self.tables)
            self._aov_cache = (self._last_pose, aovs)
        return self._aov_cache[1]
