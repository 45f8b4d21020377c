"""The plain reference of the ``fog_lights_1m`` configuration's render
step: one wavefront iteration for chosen queue slots, in plain PyTorch,
with no BVH.

It reimplements, from the scene generator's own arrays
(``perfbench/scenes/fog_lights.py``: the terrain, its lamp triangles, the
sphere rows and the delta lights), camera pose and sun, what the
program's step computes for a slot on the fogged many-light scene:

- the camera ray of a fresh slot, and the closest hit against every
  triangle (Möller-Trumbore with back-face culling, by brute force) and
  every sphere;
- the height fog's free flight: one draw a segment from its own stream
  (0xF06), inverted through the closed-form optical depth of density
  ``exp(-fog_falloff z)`` over the segment's overlap with the slab; a
  collision before the surface is a medium event (albedo ``sigma_s /
  sigma_t`` through the throughput's colour multiply, normal ``-d``);
- next-event estimation: the sun cone or a light by a fair coin (stream
  0xC0F1), the light picked by one row of a Vose alias table built here
  from the lights' powers (stream 0x11F7; 0.75 power share plus 0.25
  uniform), a uniform point on a picked sphere or (two-sided) lamp
  triangle, a point or spot light's 1/d^2 with the spot's smooth cone, a
  directional light's irradiance; the DIFF and PHONG estimators, and at a
  medium event the Henyey-Greenstein phase in the BRDF's place;
- every shadow ray's colour times the fog's transmittance along its
  segment (to the slab's exit for the sun and a directional light);
- the bounce (DIFF, SPEC, REFR, PHONG, and at a medium event the HG
  inverse CDF from its own stream, 0xF09), Russian roulette, the shadow
  ray's any hit against every triangle and sphere (a light's range
  stopped 1e-3 of its distance short, as the program's is in a scene with
  lamp triangles), and what the slot adds to its pixel when its path
  ends.

Random numbers come from the same stateless xorshift streams, keyed by
(frame, pixel, slot), so a slot's path is determined.  The functions are
frozen copies of the program's arithmetic for those features
(``render.py``, ``scene/scene.py``'s light tables, ``ops/rng.py``,
``ops/sampling.py``, ``ops/intersect.py``, ``sky.py`` at the commit this
reference was written against; the helpers it shares with
``pathtracer.py`` are copied from there, since a reference is loaded by
its path, outside any package), restricted to the configuration's
settings: perspective camera, xorshift sampler, fog on, power light
picking over more than 64 lights, no MIS, envmap, textures, smooth
normals, dispersion or clamp.  Every float tensor is in ``dtype``, so the
same code computed in bfloat16 is the configuration's lower-precision
control.  Nothing of the program is imported.

Departures from the program, none of which changes a result:

- the alias table is built here from the powers by Vose's method (the
  program's ``scene/envlight.build_alias`` and ``Scene._light_tables``
  give the same rows: the same float32 powers, the same float64 mixture
  and the same stack order);
- a slot's light is looked up by its pick index in the reference's own
  lists of sphere, triangle and delta lights, where the program selects
  among the sphere lights by a chain of ``where`` and gathers table rows;
- the closest and any hits are brute force over every triangle, where
  the program walks its BVH: a hit distance may differ by a few ulps.

Tolerances: none is applied here.  The comparison
(``perfbench/check.py``) holds each pixel's accumulation delta and
carried rays to float32 rounding with a wide margin (1e-3 relative).  A
free-flight collision or an alias coin can flip only where its draw lies
within that rounding of its threshold, which a sample of tens of
thousands of slots almost never meets.
"""

from __future__ import annotations

import math

import numpy as np
import torch

PI = 3.1415926535897932
INV_PI = 1.0 / PI
EPSILON = 1e-3
VERY_FAR = 1e20
PHONG_EXPONENT = 40.0
DIFF, SPEC, REFR, PHONG, LIGHT = 0, 1, 2, 3, 4
# the sky's settings (SkyConfig defaults)
SUN_SIZE_DEGREES = 1.5
CUTOFF_ANGLE = PI / 1.95
STEEPNESS = 1.5
SKY_FACTOR = 1.0
TURBIDITY = 1.0
MIE_COEFFICIENT = 0.005
MIE_DIRECTIONAL_G = 0.80
JUNGE_V = 4.0
RAYLEIGH_ZENITH_LENGTH = 8.4e3
MIE_ZENITH_LENGTH = 1.25e3
SUN_INTENSITY = 1000.0
PRIMARY_WAVELENGTHS = (680e-9, 550e-9, 450e-9)
K = (0.686, 0.678, 0.666)
RAYLEIGH_AT_X = (5.176821e-6, 1.2785348e-5, 2.8530756e-5)
SUN_COS = math.cos(SUN_SIZE_DEGREES * PI / 180.0)

BRUTE_PAIRS = 1 << 25  # ray-triangle pairs a chunk of the brute force

# --------------------------------------------------------------------------
# xorshift streams: uint32 values in int64 tensors
# --------------------------------------------------------------------------

_MASK = 0xFFFFFFFF
_GOLDEN = 0x9E3779B9
_INV_2_32 = 2.3283064365387e-10


def _u32(p):
    if isinstance(p, torch.Tensor):
        return p.to(torch.int64) & _MASK
    return int(p) & _MASK


def seed_from(*parts, like=None):
    """A mixed uint32 seed (as int64) from integer components."""
    h = _GOLDEN
    for p in parts:
        p = _u32(p)
        h = ((p + _GOLDEN + ((h << 6) & _MASK) + (h >> 2)) & _MASK) ^ h
        h = (h ^ 61) ^ (h >> 16)
        h = (h * 9) & _MASK
        h = h ^ (h >> 4)
        h = (h * 0x27D4EB2D) & _MASK
        h = h ^ (h >> 15)
    if not isinstance(h, torch.Tensor):
        h = torch.tensor(h, dtype=torch.int64, device=like)
    return torch.where(h == 0, torch.full_like(h, 0x1337C0DE), h)


def xorshift(seed):
    seed = seed ^ ((seed << 13) & _MASK)
    seed = seed ^ (seed >> 17)
    return seed ^ ((seed << 5) & _MASK)


def random_float(seed):
    """Uniform float32 in [0, 1)."""
    seed = xorshift(seed)
    return seed, seed.to(torch.float32) * _INV_2_32


def random_float2(seed):
    """Uniform float32 in [0, 1] with 16-bit granularity."""
    seed = xorshift(seed)
    return seed, (seed >> 16).to(torch.float32) / 65535.0


def random_2d_stratified(seed):
    seed, f = random_float(seed)
    stratum = (f * (15 + 0.99999)).to(torch.int32)
    sx = (stratum % 4).to(torch.float32)
    sy = ((stratum // 4) % 4).to(torch.float32)
    seed, jx = random_float(seed)
    seed, jy = random_float(seed)
    return seed, torch.stack([sx * 0.25 + jx * 0.25, sy * 0.25 + jy * 0.25],
                             dim=-1)


# --------------------------------------------------------------------------
# vectors and samplers
# --------------------------------------------------------------------------

def dot(a, b):
    return (a * b).sum(-1)


def normalize(v, eps: float = 1e-20):
    return v / torch.sqrt(torch.clamp(dot(v, v), min=eps))[..., None]


def cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def reflect(d, n):
    return d - 2.0 * dot(d, n)[..., None] * n


def _col(x):
    return x[:, None]


def orthonormal_basis(w):
    pick_y = torch.abs(w[..., 0]) > 0.9
    ey = torch.tensor((0.0, 1.0, 0.0), dtype=w.dtype, device=w.device)
    ex = torch.tensor((1.0, 0.0, 0.0), dtype=w.dtype, device=w.device)
    a = torch.where(pick_y[..., None], ey, ex).expand_as(w)
    u = normalize(cross(a, w))
    return u, cross(w, u)


def ortho(v):
    use_x = torch.abs(v[..., 0]) > torch.abs(v[..., 2])
    zero = torch.zeros_like(v[..., 0])
    o_a = torch.stack([-v[..., 1], v[..., 0], zero], -1)
    o_b = torch.stack([zero, -v[..., 2], v[..., 1]], -1)
    return torch.where(use_x[..., None], o_a, o_b)


def concentric_sample_disk(u):
    off = 2.0 * u - 1.0
    ox, oy = off[..., 0], off[..., 1]
    degenerate = (ox == 0) & (oy == 0)
    x_major = torch.abs(ox) > torch.abs(oy)
    safe_ox = torch.where(ox == 0, torch.ones_like(ox), ox)
    safe_oy = torch.where(oy == 0, torch.ones_like(oy), oy)
    r = torch.where(x_major, ox, oy)
    theta = torch.where(x_major, (PI / 4) * (oy / safe_ox),
                        (PI / 2) - (PI / 4) * (ox / safe_oy))
    pt = r[..., None] * torch.stack([torch.cos(theta), torch.sin(theta)], -1)
    return torch.where(degenerate[..., None], torch.zeros_like(pt), pt)


class Draws:
    """The uniform draws of one ray stream, in ``dtype``."""

    def __init__(self, dtype):
        self.dt = dtype

    def f(self, seed):
        seed, u = random_float(seed)
        return seed, u.to(self.dt)

    def f2(self, seed):
        seed, u = random_float2(seed)
        return seed, u.to(self.dt)

    def cone(self, direction, extent, seed):
        seed, rx = self.f2(seed)
        seed, ry = self.f2(seed)
        d = normalize(direction)
        o1 = normalize(ortho(d))
        o2 = normalize(cross(d, o1))
        phi = rx * 2.0 * PI
        z = 1.0 - ry * extent
        oneminus = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
        return seed, (torch.cos(phi) * oneminus)[..., None] * o1 \
            + (torch.sin(phi) * oneminus)[..., None] * o2 + z[..., None] * d

    def cosine_hemisphere(self, normal, seed):
        seed, r1u = self.f(seed)
        seed, r2 = self.f(seed)
        r1 = 2.0 * PI * r1u
        r2s = torch.sqrt(r2)
        u, v = orthonormal_basis(normal)
        d = u * (torch.cos(r1) * r2s)[..., None] \
            + v * (torch.sin(r1) * r2s)[..., None] \
            + normal * torch.sqrt(torch.clamp(1.0 - r2, min=0.0))[..., None]
        return seed, normalize(d)

    def phong_lobe(self, w, exponent, seed):
        seed, phi_u = self.f(seed)
        seed, r2 = self.f(seed)
        phi = 2.0 * PI * phi_u
        cos_theta = torch.pow(torch.clamp(1.0 - r2, min=0.0),
                              1.0 / (exponent + 1.0))
        sin_theta = torch.sqrt(torch.clamp(1.0 - cos_theta * cos_theta,
                                           min=0.0))
        u, v = orthonormal_basis(w)
        d = u * (torch.cos(phi) * sin_theta)[..., None] \
            + v * (torch.sin(phi) * sin_theta)[..., None] \
            + w * cos_theta[..., None]
        return seed, normalize(d)


# --------------------------------------------------------------------------
# sun and sky (Rayleigh + Mie)
# --------------------------------------------------------------------------

def sun_direction(sun_position, device, dtype):
    """The UI's 2-D sun position as a unit world direction [3]."""
    pos = torch.as_tensor(sun_position, dtype=torch.float32, device=device)
    half = torch.tensor([0.0, 0.5], dtype=torch.float32, device=device)
    scale = torch.tensor([6.28, 3.14], dtype=torch.float32, device=device)
    p = (pos - half) * scale
    v = torch.stack([torch.cos(p[..., 0]) * torch.sin(p[..., 1]),
                     torch.sin(p[..., 0]) * torch.sin(p[..., 1]),
                     torch.cos(p[..., 1])], dim=-1)
    return normalize(v).to(dtype)


class Sky:
    def __init__(self, device, dtype):
        def t(v):
            return torch.tensor(v, dtype=torch.float32, device=device)
        c = (0.2 * TURBIDITY) * 10e-18
        mie = 0.434 * c * PI * torch.pow((2.0 * PI) / t(PRIMARY_WAVELENGTHS),
                                         JUNGE_V - 2.0) * t(K)
        self.mie = (mie * MIE_COEFFICIENT).to(dtype)
        self.rayleigh = t(RAYLEIGH_AT_X).to(dtype)
        self.up = t((0.0, 0.0, 1.0)).to(dtype)

    def _common(self, view_dir, sun_dir):
        cos_view_sun = dot(view_dir, sun_dir)
        cos_sun_up = dot(sun_dir, self.up)
        cos_up_view = dot(self.up, view_dir)
        sun_e = SUN_INTENSITY * torch.clamp(
            1.0 - torch.exp(-((CUTOFF_ANGLE - torch.arccos(
                torch.clamp(cos_sun_up, -1.0, 1.0))) / STEEPNESS)), min=0.0)
        rayleigh, mie = self.rayleigh, self.mie
        zenith = torch.clamp(cos_up_view, min=0.0)
        fex = torch.exp(-(rayleigh * (RAYLEIGH_ZENITH_LENGTH / zenith[..., None])
                          + mie * (MIE_ZENITH_LENGTH / zenith[..., None])))
        ray_phase = (3.0 / (16.0 * PI)) * (1.0 + cos_view_sun * cos_view_sun)
        g = MIE_DIRECTIONAL_G
        hg = (1.0 / (4.0 * PI)) * ((1.0 - g * g) / torch.pow(
            1.0 - 2.0 * g * cos_view_sun + g * g, 1.5))
        light_frac = (rayleigh * ray_phase[..., None]
                      + mie * hg[..., None]) / (rayleigh + mie)
        something = sun_e[..., None] * light_frac
        sky_term = something * (1.0 - fex)
        mix_t = torch.clamp(torch.pow(1.0 - dot(self.up, sun_dir), 5.0),
                            0.0, 1.0)
        low_sun = torch.pow(torch.clamp(something * fex, min=0.0), 0.5)
        sky_term = sky_term * ((1.0 - mix_t) + mix_t * low_sun)
        return sun_e, fex, sky_term, cos_view_sun

    def sun(self, view_dir, sun_dir):
        """Solar-disc radiance toward ``view_dir`` (sun NEE)."""
        sun_e, fex, _, cos_view_sun = self._common(view_dir, sun_dir)
        disk = (cos_view_sun >= SUN_COS).to(fex.dtype)
        return 0.01 * (sun_e[..., None] * 19000.0 * fex) * disk[..., None]

    def sky_and_sunsky(self, view_dir, sun_dir):
        """(sky, sky with the smoothstep solar disc): the radiance of a
        diffuse-born and of a specular-born miss."""
        sun_e, fex, sky_term, cos_view_sun = self._common(view_dir, sun_dir)
        t = torch.clamp((cos_view_sun - SUN_COS) / 0.00002, 0.0, 1.0)
        disk = t * t * (3.0 - 2.0 * t)
        disc = (sun_e[..., None] * 19000.0 * fex) * disk[..., None] * 1e-5
        return SKY_FACTOR * 0.01 * sky_term, 0.01 * (disc + sky_term)


# --------------------------------------------------------------------------
# intersection, by brute force
# --------------------------------------------------------------------------

def moller_trumbore(origin, direction, vert, e1, e2):
    """t of a front-face hit (det >= 1e-7), else 0."""
    ox, oy, oz = origin.unbind(-1)
    dx, dy, dz = direction.unbind(-1)
    v0x, v0y, v0z = vert.unbind(-1)
    e1x, e1y, e1z = e1.unbind(-1)
    e2x, e2y, e2z = e2.unbind(-1)
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    inv_det = 1.0 / torch.where(torch.abs(det) < 1e-30,
                                torch.ones_like(det), det)
    tx = ox - v0x
    ty = oy - v0y
    tz = oz - v0z
    u = (tx * px + ty * py + tz * pz) * inv_det
    qx = ty * e1z - tz * e1y
    qy = tz * e1x - tx * e1z
    qz = tx * e1y - ty * e1x
    v = (dx * qx + dy * qy + dz * qz) * inv_det
    t = (e2x * qx + e2y * qy + e2z * qz) * inv_det
    valid = (det >= 1e-7) & (u >= 0) & (u <= 1) & (v >= 0) & (u + v <= 1)
    return torch.where(valid, t, torch.zeros_like(t))


def ray_sphere(origin, direction, center, radius):
    """Nearest root > epsilon, else the far root if > epsilon, else 0."""
    op = center - origin
    b = (op * direction).sum(-1)
    disc = b * b - (op * op).sum(-1) + radius * radius
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    t_near = b - sq
    t_far = b + sq
    zero = torch.zeros_like(t_near)
    t = torch.where(t_near > EPSILON, t_near,
                    torch.where(t_far > EPSILON, t_far, zero))
    return torch.where(disc < 0, zero, t)


def _chunks(n, n_tri):
    step = max(1, BRUTE_PAIRS // max(n_tri, 1))
    return range(0, n, step), step


def closest_triangle(origin, direction, vert, e1, e2):
    """(t, index) of the nearest front-face triangle beyond epsilon, over
    every triangle; VERY_FAR and -1 on a miss."""
    n = origin.shape[0]
    t = torch.full((n,), VERY_FAR, dtype=origin.dtype, device=origin.device)
    idx = torch.full((n,), -1, dtype=torch.int64, device=origin.device)
    starts, step = _chunks(n, vert.shape[0])
    for s in starts:
        t_all = moller_trumbore(origin[s:s + step, None], direction[s:s + step,
                                                                    None],
                                vert[None], e1[None], e2[None])
        t_all = torch.where(t_all > EPSILON, t_all,
                            torch.full_like(t_all, VERY_FAR))
        tm, i = torch.min(t_all, dim=1)
        t[s:s + step] = tm
        idx[s:s + step] = torch.where(tm < VERY_FAR, i, torch.full_like(i, -1))
    return t, idx


def occluded_by_triangles(origin, direction, max_dist, vert, e1, e2):
    """Whether any triangle has epsilon < t < max_dist - epsilon."""
    n = origin.shape[0]
    occ = torch.zeros((n,), dtype=torch.bool, device=origin.device)
    starts, step = _chunks(n, vert.shape[0])
    for s in starts:
        t_all = moller_trumbore(origin[s:s + step, None], direction[s:s + step,
                                                                    None],
                                vert[None], e1[None], e2[None])
        lim = max_dist[s:s + step, None]
        occ[s:s + step] = ((t_all > EPSILON)
                           & ((lim - t_all) > EPSILON)).any(1)
    return occ




def scan_pixels(width, height, start, slots):
    """The pixel each fresh slot renders: the round-robin scan from
    ``start``, in 8x8 screen tiles when both sides divide by 8."""
    total = width * height
    scan = (start + slots) % total
    if width % 8 == 0 and height % 8 == 0:
        tile = scan // 64
        within = scan % 64
        x = (tile % (width // 8)) * 8 + within % 8
        y = (tile // (width // 8)) * 8 + within // 8
    else:
        x = scan % width
        y = scan // width
    return y * width + x, x, y


# --------------------------------------------------------------------------
# fog: a slab z in [fog_z_min, fog_z_max] of density sigma exp(-falloff z)
# --------------------------------------------------------------------------

def fog_overlap(origin, direction, t_limit, z_min: float, z_max: float):
    """(t_enter, length) of the rays' overlap with the slab, clipped to
    [0, t_limit]; length 0 for a ray that never crosses it."""
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


def fog_density(origin, direction, t_start, falloff: float):
    """(rho0, k): density(s) = rho0 exp(-k s) along a segment from
    ``t_start``, rho0's exponent clamped to +-60."""
    z_start = origin[:, 2] + direction[:, 2] * t_start
    rho0 = torch.exp(torch.clamp(-falloff * z_start, -60.0, 60.0))
    return rho0, falloff * direction[:, 2]


def optical_depth(sigma_t: float, rho0, k, s):
    """sigma_t rho0 (1 - exp(-k s)) / k, and sigma_t rho0 s as k -> 0."""
    tiny = torch.abs(k) < 1e-12
    k_safe = torch.where(tiny, 1.0, k)
    ratio = torch.where(tiny, s, -torch.expm1(-k_safe * s) / k_safe)
    return sigma_t * rho0 * ratio


def free_flight(u, sigma_t: float, rho0, k):
    """The distance whose optical depth is -log(1 - u); VERY_FAR where the
    ray climbs out of the fog before that depth accrues."""
    e = -torch.log1p(-torch.clamp(u, max=1.0 - 1e-7))
    tiny = torch.abs(k) < 1e-12
    k_safe = torch.where(tiny, 1.0, k)
    g = e * k_safe / (sigma_t * rho0)
    s_het = -torch.log1p(-torch.clamp(g, max=1.0 - 1e-12)) / k_safe
    s = torch.where(tiny, e / (sigma_t * rho0), s_het)
    return torch.where(~tiny & (g >= 1.0), VERY_FAR, s)


def hg_phase(cos_theta, g: float):
    """The Henyey-Greenstein phase, its own solid-angle pdf."""
    if abs(g) < 1e-4:
        return torch.full_like(cos_theta, 1.0 / (4.0 * PI))
    denom = torch.clamp(1.0 + g * g - 2.0 * g * cos_theta, min=1e-12)
    return (1.0 - g * g) / (4.0 * PI * denom * torch.sqrt(denom))


def hg_sample(direction, g: float, u1, u2):
    """A direction by the HG inverse CDF in cos(theta) around
    ``direction``."""
    d = normalize(direction)
    if abs(g) < 1e-4:
        cos_t = 1.0 - 2.0 * u1
    else:
        sq = (1.0 - g * g) / (1.0 - g + 2.0 * g * u1)
        cos_t = (1.0 + g * g - sq * sq) / (2.0 * g)
    cos_t = torch.clamp(cos_t, -1.0, 1.0)
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
    phi = 2.0 * PI * u2
    u, v = orthonormal_basis(d)
    return u * (torch.cos(phi) * sin_t)[..., None] \
        + v * (torch.sin(phi) * sin_t)[..., None] \
        + d * cos_t[..., None]


# --------------------------------------------------------------------------
# the lights: powers, Vose's alias table, the pick
# --------------------------------------------------------------------------

LUM_RGB = np.array([0.2126, 0.7152, 0.0722], np.float32)
FOG = 6       # a medium event's pseudo-material
ALIAS_OVER = 64  # lights beyond which the pick reads alias rows


def vose(p: np.ndarray):
    """Vose's alias method (M. D. Vose, IEEE TSE 17(9), 1991) over the
    probabilities ``p`` [n] (float64, summing to 1): (prob [n] float32,
    alias [n] int64); draw i uniformly, keep it if a uniform is below
    prob[i], else take alias[i].  The small and large worklists hold the
    indices in ascending order and are popped from their ends."""
    n = p.shape[0]
    prob = np.zeros(n, np.float64)
    alias = np.arange(n, dtype=np.int64)
    scaled = p.astype(np.float64) * n
    small = [i for i in range(n) if scaled[i] < 1.0]
    large = [i for i in range(n) if scaled[i] >= 1.0]
    while small and large:
        s = small.pop()
        g = large.pop()
        prob[s] = scaled[s]
        alias[s] = g
        scaled[g] = (scaled[g] + scaled[s]) - 1.0
        (small if scaled[g] < 1.0 else large).append(g)
    for i in large + small:
        prob[i] = 1.0
    return prob.astype(np.float32), alias


def light_powers(sphere_em, sphere_r, tri_rows, delta_rows) -> list:
    """Each light's power in the pick order (sphere lights, lamp
    triangles, delta lights), in the program's float32 terms: luminance
    times area (4 pi r^2 for a sphere), a delta light's luminance times a
    solid angle (point 4 pi, spot its cone's mean, directional 1)."""
    powers = []
    for em, r in zip(sphere_em, sphere_r):
        r32 = np.float32(r)
        powers.append(float(np.float32(np.asarray(em, np.float32) @ LUM_RGB)
                            * np.float32(4.0 * np.pi) * r32 * r32))
    for row in tri_rows:
        powers.append(float(np.float32(row[9:12] @ LUM_RGB) * row[12]))
    for row in delta_rows:
        lum = float(row[7:10] @ LUM_RGB)
        if row[0] == 0.0:
            sa = 4.0 * np.pi
        elif row[0] == 1.0:
            sa = 2.0 * np.pi * (1.0 - 0.5 * (row[10] + row[11]))
        else:
            sa = 1.0
        powers.append(lum * sa)
    return powers


class Lights:
    """The power pick over ``powers``: up to 64 lights a CDF of the
    float32 mixture 0.75 power / total + 0.25 / count, beyond that one
    Vose row [keep, alias, 1/pdf, 1/pdf(alias)] of the float64 mixture."""

    def __init__(self, powers: list, device):
        self.count = n = len(powers)
        self.device = device
        if n > ALIAS_OVER:
            total = float(np.sum(np.asarray(powers, np.float64)))
            pm = (0.75 * np.asarray(powers, np.float64) / total + 0.25 / n
                  if total > 0.0 else np.full(n, 1.0 / n))
            prob, alias = vose(pm)
            inv = np.where(pm > 0, 1.0 / np.maximum(pm, 1e-300), 0.0)
            rows = np.zeros((n, 4), np.float32)
            rows[:, 0], rows[:, 1] = prob, alias
            rows[:, 2], rows[:, 3] = inv, inv[alias]
            self.alias = torch.as_tensor(rows, device=device)
        else:
            pw = torch.as_tensor(np.asarray(powers, np.float32))
            total = pw.sum()
            pdfs = torch.where(total > 0, 0.75 * pw / torch.clamp(
                total, min=1e-30) + 0.25 / n, torch.full_like(pw, 1.0 / n))
            self.cdf = torch.cumsum(pdfs, 0).to(device)
            self.inv_pdf = (1.0 / torch.clamp(pdfs, min=1e-30)).to(device)

    def pick(self, lu):
        """(light [N] int32, 1 / its pick probability [N] float32) of the
        float32 uniforms ``lu``: one alias row (the scaled uniform's
        fraction its coin) or the count of CDF entries at or below it."""
        n = self.count
        if n > ALIAS_OVER:
            i0 = torch.clamp((lu * n).to(torch.int32), max=n - 1)
            frac = lu * n - i0.to(torch.float32)
            row = self.alias[i0.long()]
            keep = frac < row[:, 0]
            return (torch.where(keep, i0, row[:, 1].to(torch.int32)),
                    torch.where(keep, row[:, 2], row[:, 3]))
        pick = (lu[:, None] >= self.cdf[None, :n - 1]).sum(1,
                                                          dtype=torch.int32)
        return pick, self.inv_pdf[pick.long()]


# --------------------------------------------------------------------------
# the scene, the camera and one step
# --------------------------------------------------------------------------

class Scene:
    """The reference's scene on ``device`` in ``dtype`` from a generator's
    arrays: the triangles (v0, e1 = v1 - v0, e2 = v2 - v0 in float32 as
    given) with their materials (``tri_refl``, ``tri_color``: DIFF or
    LIGHT), the sphere rows, the lamp triangles (those of ``tri_refl``
    LIGHT, in the triangle list's order: v0, e1, e2, emission, area), the
    delta lights (kind, position, direction, intensity, cos_inner,
    cos_outer), the light pick, the sun and the sky."""

    def __init__(self, kw: dict, sun_position, device, dtype=torch.float32):
        v0 = np.asarray(kw["v0"], np.float32)
        e1 = np.asarray(kw["v1"], np.float32) - v0
        e2 = np.asarray(kw["v2"], np.float32) - v0
        n_t = v0.shape[0]
        refl_t = np.asarray(kw.get("tri_refl", np.zeros(n_t)), np.int32)
        color_t = np.asarray(kw["tri_color"], np.float32) \
            if "tri_color" in kw else np.ones((n_t, 3), np.float32)
        bad = sorted(set(np.unique(refl_t).tolist()) - {DIFF, LIGHT})
        if bad:
            raise ValueError(f"the reference shades no triangle material "
                             f"{bad}")
        sph = kw["spheres"]

        def t(a):
            return torch.as_tensor(np.asarray(a, np.float32),
                                   device=device).to(dtype)
        self.device, self.dtype = torch.device(device), dtype
        self.vert, self.e1, self.e2 = t(v0), t(e1), t(e2)
        self.tri_refl = torch.as_tensor(refl_t, device=device)
        self.tri_color = t(color_t)
        self.center, self.radius = t(sph.center), t(sph.radius)
        self.color, self.emission = t(sph.color), t(sph.emission)
        refl = np.asarray(sph.refl, np.int32)
        self.refl = torch.as_tensor(refl, device=device)
        self.light_spheres = [int(i) for i in np.nonzero(refl == LIGHT)[0]]

        lamp = refl_t == LIGHT
        le1, le2 = e1[lamp], e2[lamp]
        area = 0.5 * np.linalg.norm(np.cross(le1, le2), axis=1)
        tri_rows = np.concatenate([v0[lamp], le1, le2, color_t[lamp],
                                   area[:, None]], 1).astype(np.float32)
        dl = kw.get("delta_lights")
        delta_rows = np.zeros((0, 12), np.float32) if dl is None else \
            np.concatenate([np.asarray(dl.kind, np.float32)[:, None],
                            np.asarray(dl.position, np.float32),
                            np.asarray(dl.direction, np.float32),
                            np.asarray(dl.intensity, np.float32),
                            np.asarray(dl.cos_inner, np.float32)[:, None],
                            np.asarray(dl.cos_outer, np.float32)[:, None]],
                           1).astype(np.float32)
        self.n_tri_lights, self.n_delta = len(tri_rows), len(delta_rows)
        if len(self.light_spheres) + self.n_tri_lights + self.n_delta < 2:
            raise ValueError("the reference shades a pick among several "
                             "lights")
        self.tri_lights = t(tri_rows if len(tri_rows)
                            else np.zeros((1, 13), np.float32))
        self.delta_lights = t(delta_rows if len(delta_rows)
                              else np.zeros((1, 12), np.float32))
        self.lights = Lights(light_powers(
            np.asarray(sph.emission, np.float32)[self.light_spheres],
            np.asarray(sph.radius, np.float32)[self.light_spheres],
            tri_rows, delta_rows), device)
        self.sun_dir = sun_direction(sun_position, device, dtype)
        self.sky = Sky(device, dtype)


class Step:
    """One wavefront step of the configuration for chosen queue slots.

    ``cfg``: the render fields (width, height, num_rays, max_bounces,
    focal_distance_scale, the fog's coefficients and slab) and seed (the
    run's RenderConfig.seed)."""

    def __init__(self, scene: Scene, cfg: dict):
        self.sc = scene
        self.cfg = cfg
        self.dt = scene.dtype
        self.draw = Draws(scene.dtype)

    def camera_rays(self, cam, start: int, frame_s: int, slots):
        """Fresh camera rays of ``slots`` (int64 [n]) for the scan from
        ``start`` under the salted frame counter: origin, direction,
        pixel."""
        w, h = self.cfg["width"], self.cfg["height"]
        dev, dt = self.sc.device, self.dt
        pixel, x_i, y_i = scan_pixels(w, h, start, slots)
        x = x_i.to(torch.float32)
        y = y_i.to(torch.float32)
        seed = seed_from(frame_s, slots, 0, 0x5EED)
        seed, uv = random_2d_stratified(seed)
        ni = ((x - uv[..., 0]) / w - 0.5).to(dt)
        nj = ((h - (y - uv[..., 1])) / h - 0.5).to(dt)
        pos, d, right, up = (torch.as_tensor(a, device=dev).to(dt)[None]
                             for a in cam)
        dir_fp = normalize(d + ni[:, None] * right + nj[:, None] * up)
        focal = torch.tensor(1.0, dtype=torch.float32, device=dev) \
            * self.cfg["focal_distance_scale"]
        conv = pos + focal.to(dt) * dir_fp
        seed, l0 = random_float(seed)
        seed, l1 = random_float(seed)
        p_lens = 0.0 * concentric_sample_disk(torch.stack([l0, l1], -1)).to(dt)
        origin = pos + p_lens[:, 0:1] * right + p_lens[:, 1:2] * up
        return origin, normalize(conv - origin), pixel

    def trace(self, origin, direction):
        """Closest hit: spheres first, then every triangle, which wins
        only when nearer than the sphere by more than epsilon.  Returns
        (t, sphere index or -1, triangle index or -1)."""
        sc = self.sc
        t_all = ray_sphere(origin[:, None, :], direction[:, None, :],
                           sc.center[None], sc.radius[None])
        t_all = torch.where(t_all > 0.0, t_all,
                            torch.full_like(t_all, VERY_FAR))
        t_sph, sph = torch.min(t_all, dim=1)
        sph = torch.where(t_sph < VERY_FAR, sph, torch.full_like(sph, -1))
        t_tri, tri = closest_triangle(origin, direction, sc.vert, sc.e1, sc.e2)
        tri_wins = (tri >= 0) & ((t_sph - t_tri) > EPSILON)
        t = torch.where(tri_wins, t_tri, t_sph)
        return t, torch.where(tri_wins, -1, sph), torch.where(tri_wins, tri, -1)

    def fog_sample(self, rays, t, frame_s: int, slots):
        """One free-flight draw a segment against its slab overlap:
        (t, is_fog), t the medium event's where a collision comes first."""
        cfg, dt = self.cfg, self.dt
        d = rays["direction"]
        sigma_t = cfg["fog_sigma_s"] + cfg["fog_sigma_a"]
        ta, length = fog_overlap(rays["origin"], d, t, cfg["fog_z_min"],
                                 cfg["fog_z_max"])
        _, u = random_float(seed_from(frame_s, rays["pixel"], slots, 0,
                                      0xF06))
        rho0, k = fog_density(rays["origin"], d, ta, cfg["fog_falloff"])
        s = free_flight(u.to(dt), sigma_t, rho0, k)
        is_fog = s < length
        return torch.where(is_fog, ta + s, t), is_fog

    def transmittance(self, o, direction, t_limit):
        """exp(-optical depth) of the slab along each segment from ``o``
        to ``t_limit``."""
        cfg = self.cfg
        ta, length = fog_overlap(o, direction, t_limit, cfg["fog_z_min"],
                                 cfg["fog_z_max"])
        rho0, k = fog_density(o, direction, ta, cfg["fog_falloff"])
        return torch.exp(-optical_depth(
            cfg["fog_sigma_s"] + cfg["fog_sigma_a"], rho0, k, length))

    def light_sample(self, o, normal, pick, lu1, lu2):
        """The picked light's sample from the shading point ``o``: (light
        emission or intensity [n, 3], ldir, ldist, cos_surf, cos_light,
        solid_angle).  A sphere or lamp triangle takes a uniform point on
        its surface (a lamp's normal turned toward ``o``); a point or spot
        light 1/d^2 with a spot's Hermite cone, a directional light its
        irradiance with cos_light 1 and an infinite range."""
        sc = self.sc
        n_s, n_t = len(sc.light_spheres), sc.n_tri_lights
        dev = o.device
        s_ids = torch.tensor(sc.light_spheres or [0], device=dev)
        sid = s_ids[torch.clamp(pick, 0, max(n_s - 1, 0)).long()]
        c, r = sc.center[sid], sc.radius[sid]
        cos_phi = 2.0 * lu1 - 1.0
        sin_phi = torch.sqrt(torch.clamp(1.0 - cos_phi * cos_phi, min=0.0))
        theta = 2.0 * PI * lu2
        offset = torch.stack([sin_phi * torch.sin(theta), cos_phi,
                              sin_phi * torch.cos(theta)], dim=-1)
        lp = c + _col(r) * offset
        n_l = normalize(lp - c)
        area = 4.0 * PI * r * r
        light_e = sc.emission[sid]

        row = sc.tri_lights[torch.clamp(pick - n_s, 0,
                                        max(n_t - 1, 0)).long()]
        su = torch.sqrt(torch.clamp(lu1, min=0.0))
        b1, b2 = 1.0 - su, lu2 * su
        lp_tri = row[:, 0:3] + _col(b1) * row[:, 3:6] + _col(b2) * row[:, 6:9]
        tn = cross(row[:, 3:6], row[:, 6:9])
        tn = tn / _col(torch.clamp(torch.sqrt(torch.clamp(
            dot(tn, tn), min=1e-30)), min=1e-30))
        is_tl = (pick >= n_s) & (pick < n_s + n_t)
        lp = torch.where(_col(is_tl), lp_tri, lp)
        light_e = torch.where(_col(is_tl), row[:, 9:12], light_e)
        area = torch.where(is_tl, row[:, 12], area)
        sgn = torch.sign(dot(tn, o - lp) + 1e-30)  # two-sided
        n_l = torch.where(_col(is_tl), tn * _col(sgn), n_l)

        lvec = lp - o
        ldist2 = dot(lvec, lvec)
        ldist = torch.sqrt(torch.clamp(ldist2, min=1e-20))
        ldir = lvec / _col(ldist)
        cos_surf = dot(normal, ldir)
        cos_light = dot(n_l, -ldir)
        solid_angle = cos_light * area / torch.clamp(ldist2, min=1e-20)

        first = n_s + n_t
        drow = sc.delta_lights[torch.clamp(pick - first, 0,
                                           max(sc.n_delta - 1, 0)).long()]
        kind, axis = drow[:, 0], drow[:, 4:7]
        is_dl = pick >= first
        is_dir = is_dl & (kind >= 2.0)
        dl_vec = drow[:, 1:4] - o
        dl_d2 = torch.clamp(dot(dl_vec, dl_vec), min=1e-12)
        dl_dist = torch.sqrt(dl_d2)
        dl_ldir = torch.where(_col(is_dir), -axis, dl_vec / _col(dl_dist))
        tt = torch.clamp((dot(axis, -dl_ldir) - drow[:, 11])
                         / torch.clamp(drow[:, 10] - drow[:, 11], min=1e-6),
                         0.0, 1.0)
        one = torch.ones_like(tt)
        fall = torch.where(kind == 1.0, tt * tt * (3.0 - 2.0 * tt), one)
        ldir = torch.where(_col(is_dl), dl_ldir, ldir)
        ldist = torch.where(is_dl, torch.where(
            is_dir, torch.full_like(dl_dist, VERY_FAR), dl_dist), ldist)
        cos_surf = torch.where(is_dl, dot(normal, dl_ldir), cos_surf)
        cos_light = torch.where(is_dl, one, cos_light)
        solid_angle = torch.where(is_dl, torch.where(is_dir, fall,
                                                     fall / dl_d2),
                                  solid_angle)
        light_e = torch.where(_col(is_dl), drow[:, 7:10], light_e)
        return light_e, ldir, ldist, cos_surf, cos_light, solid_angle

    def run(self, rays: dict, slots, frame_s: int):
        """Extend, fog, shade, connect and roulette for ``rays`` (origin,
        direction, direct, pending [n, 3]; pixel, bounces [n];
        last_specular [n] bool) at queue ``slots``.  Returns the per-ray
        outcome: survive, the next ray's fields, the flush (pending plus
        this bounce's contribution, which a ray that ends adds to its
        pixel), whether the slot traced a valid shadow ray, and what it
        did (``is_fog``, the light ``pick`` and whether it took the light
        strategy at a point that samples lights, ``nee_light``)."""
        sc, cfg, dr = self.sc, self.cfg, self.draw
        eps = EPSILON
        g = cfg["fog_g"]
        d = rays["direction"]
        pixel, bounces = rays["pixel"], rays["bounces"]
        last_spec_in = rays["last_specular"]
        t, sph, tri = self.trace(rays["origin"], d)
        t, is_fog = self.fog_sample(rays, t, frame_s, slots)

        hit = t < VERY_FAR
        t_safe = torch.where(hit, t, torch.zeros_like(t))
        o = rays["origin"] + d * _col(t_safe)
        is_sphere = hit & (sph >= 0) & ~is_fog
        sid = torch.clamp(sph, min=0)
        tid = torch.clamp(tri, min=0)
        normal_sphere = (o - sc.center[sid]) / _col(sc.radius[sid])
        tn = cross(sc.e1[tid], sc.e2[tid])
        normal_tri = tn / _col(torch.sqrt(torch.clamp(dot(tn, tn), min=1e-30)))
        normal = torch.where(_col(is_sphere), normal_sphere, normal_tri)
        normal = torch.where(_col(is_fog), -d, normal)
        refl_tri = sc.tri_refl[tid]
        refl = torch.where(is_sphere, sc.refl[sid], refl_tri)
        refl = torch.where(hit, refl, DIFF)
        refl = torch.where(is_fog, FOG, refl)
        albedo = cfg["fog_sigma_s"] / (cfg["fog_sigma_s"] + cfg["fog_sigma_a"])
        obj_color = torch.where(_col(is_sphere), sc.color[sid],
                                sc.tri_color[tid])
        obj_color = torch.where(_col(is_fog), albedo, obj_color)

        mul_mask = hit & (refl != REFR) & (refl != LIGHT)
        direct = rays["direct"] * torch.where(_col(mul_mask), obj_color,
                                              torch.ones_like(obj_color))
        outside = dot(normal, d) < 0
        normal = torch.where(_col(outside), normal, -normal)
        o = o + normal * eps

        # an emitter hit (a LIGHT sphere or lamp triangle) counts on
        # specular-born paths and stops the throughput of diffuse-born ones
        is_light = hit & (refl == LIGHT)
        emission = torch.where(_col(is_sphere), sc.emission[sid],
                               torch.where(_col(refl_tri == LIGHT),
                                           sc.tri_color[tid],
                                           torch.zeros_like(direct)))
        color = torch.where(_col(is_light & last_spec_in), direct * emission,
                            torch.zeros_like(direct))
        direct = torch.where(_col(is_light & ~last_spec_in),
                             torch.zeros_like(direct), direct)

        # next-event estimation: the sun cone or a picked light, by coin
        seed = seed_from(frame_s, pixel, slots, 0, 0x5ADE)
        n = o.shape[0]
        sun_dir = sc.sun_dir
        seed, sun_sample = dr.cone(sun_dir.expand(n, 3), 1.0 - SUN_COS, seed)
        sun_cos = dot(normal, sun_sample)
        _, cs_u = random_float(seed_from(frame_s, pixel, slots, 0, 0xC0F1))
        choose_sun = cs_u < 0.5
        inv_p_sun = inv_p_light = 2.0
        _, lu = random_float(seed_from(frame_s, pixel, slots, 0, 0x11F7))
        pick, inv_pick = sc.lights.pick(lu)
        seed, lu1 = dr.f(seed)
        seed, lu2 = dr.f(seed)
        light_e, ldir, ldist, cos_surf, cos_light, solid_angle = \
            self.light_sample(o, normal, pick, lu1, lu2)
        nl = _col((inv_p_light * inv_pick).to(self.dt))

        sun_radiance = sc.sky.sun(sun_sample, sun_dir)
        c_diff = c_spec = 1e-5
        diff_sun_color = inv_p_sun * direct * sun_radiance \
            * _col(sun_cos * c_diff)
        diff_sun_ok = choose_sun & (sun_cos > 0)
        diff_light_color = light_e * nl * direct \
            * _col(solid_angle * INV_PI * cos_surf)
        diff_light_ok = ~choose_sun & (cos_surf > 0) & (cos_light > 0)
        pe = PHONG_EXPONENT
        w_refl = normalize(d - normal * _col(2.0 * dot(normal, d)))
        phong_cos_sun = dot(sun_sample, w_refl)
        phong_sun_color = inv_p_sun * direct * ((pe + 2.0) * 0.5 * INV_PI) \
            * sun_radiance * _col(sun_cos * torch.pow(
                torch.clamp(phong_cos_sun, min=0.0), pe) * c_spec)
        phong_sun_ok = choose_sun & (sun_cos > 0) & (phong_cos_sun > eps)
        phong_cos_l = dot(ldir, w_refl)
        phong_light_color = light_e * nl * direct \
            * _col(solid_angle * (pe + 2.0) * 0.5 * INV_PI
                   * torch.pow(torch.clamp(phong_cos_l, min=0.0), pe)
                   * cos_surf)
        phong_light_ok = ~choose_sun & (cos_surf > 0) & (cos_light > 0) \
            & (phong_cos_l > eps)
        is_diff = hit & (refl == DIFF)
        is_phong = hit & (refl == PHONG)
        shadow_ok = (is_diff & (diff_sun_ok | diff_light_ok)) \
            | (is_phong & (phong_sun_ok | phong_light_ok))
        sun_c = _col(choose_sun)
        shadow_dir = torch.where(sun_c, sun_sample, ldir)
        shadow_color = torch.where(
            _col(is_diff), torch.where(sun_c, diff_sun_color,
                                       diff_light_color),
            torch.where(sun_c, phong_sun_color, phong_light_color))
        # a medium event: the phase function in the BRDF-times-cosine's
        # place (the sun keeps the DIFF estimator's 1e-5 scale: pi 1e-5)
        fog_sun_color = inv_p_sun * direct * sun_radiance * _col(
            hg_phase(dot(d, sun_sample), g) * (PI * 1e-5))
        fog_light_color = light_e * nl * direct * _col(
            solid_angle * hg_phase(dot(d, ldir), g))
        fog_light_ok = ~choose_sun & (cos_light > 0)
        shadow_ok = torch.where(is_fog, choose_sun | fog_light_ok, shadow_ok)
        shadow_color = torch.where(
            _col(is_fog), torch.where(sun_c, fog_sun_color, fog_light_color),
            shadow_color)
        # the sun's range is unbounded; a light's stops 1e-3 of its
        # distance short of the sampled point, and every connection pays
        # the slab's transmittance (to its exit for the sun)
        shadow_maxd = torch.where(choose_sun, torch.full_like(ldist, VERY_FAR),
                                  ldist * (1.0 - 1e-3))
        shadow_color = shadow_color * _col(self.transmittance(
            o, shadow_dir, torch.where(choose_sun, VERY_FAR, ldist)))

        # the bounce: DIFF cosine lobe, SPEC mirror, REFR Fresnel/TIR with
        # Beer-Lambert, PHONG lobe with rejection, the HG lobe at a medium
        # event
        seed, diff_dir = dr.cosine_hemisphere(normal, seed)
        diff_new_dir = torch.where(_col(bounces < cfg["max_bounces"]),
                                   diff_dir, d)
        spec_dir = reflect(d, normal)
        one = torch.ones_like(t_safe)
        eta = 1.2
        n1 = torch.where(outside, one * eta, one)
        n2 = torch.where(outside, one, one * eta)
        r0 = ((n1 - n2) / (n1 + n2)) ** 2
        cos_i = -dot(normal, d)
        nr = n2 / n1
        sin_t2 = nr * nr * (1.0 - cos_i * cos_i)
        fresnel = torch.where(sin_t2 > 1.0, one, r0 + (1.0 - r0) * torch.pow(
            torch.clamp(1.0 - cos_i, min=0.0), 5.0))
        seed, fr = dr.f(seed)
        refr_reflects = fr < fresnel
        cos_t = torch.sqrt(torch.clamp(1.0 - sin_t2, min=0.0))
        refr_dir = _col(nr) * d + _col(nr * cos_i - cos_t) * normal
        refr_new_dir = torch.where(_col(refr_reflects), spec_dir, refr_dir)
        is_refr = hit & (refl == REFR)
        beer = torch.exp(-obj_color * _col(t_safe))
        direct = direct * torch.where(_col(is_refr & ~outside), beer,
                                      torch.ones_like(beer))
        seed, cur = dr.phong_lobe(w_refl, pe, seed)
        ok = dot(cur, normal) > eps
        for _ in range(8):
            seed, cand = dr.phong_lobe(w_refl, pe, seed)
            take = ~ok & (dot(cand, normal) > eps)
            cur = torch.where(_col(take), cand, cur)
            ok = ok | take
        phong_dir = torch.where(_col(ok), cur, w_refl)
        new_dir = torch.where(_col(is_diff), diff_new_dir, d)
        new_dir = torch.where(_col(hit & (refl == SPEC)), spec_dir, new_dir)
        new_dir = torch.where(_col(is_refr), refr_new_dir, new_dir)
        new_dir = torch.where(_col(is_phong), phong_dir, new_dir)
        fs = seed_from(frame_s, pixel, slots, 0, 0xF09)
        fs, fu1 = dr.f(fs)
        _, fu2 = dr.f(fs)
        new_dir = torch.where(_col(is_fog), hg_sample(d, g, fu1, fu2), new_dir)
        new_last_spec = (hit & (refl == SPEC)) | (is_refr & refr_reflects)
        zero = torch.zeros_like(normal)
        origin_out = o \
            + torch.where(_col(is_refr & ~refr_reflects), -2.0 * eps * normal,
                          zero) \
            + torch.where(_col(is_phong), eps * w_refl, zero)

        # Russian roulette
        p = torch.clamp(direct.amax(-1), max=1.0)
        seed, rr = dr.f(seed)
        survive = hit & (bounces < cfg["max_bounces"]) & (p > eps) & (rr <= p)
        direct_out = torch.where(_col(survive),
                                 direct / _col(torch.clamp(p, min=1e-20)),
                                 direct)

        # a miss sees the sky (with the sun disc on specular-born rays)
        sky_v, sunsky_v = sc.sky.sky_and_sunsky(d, sun_dir)
        miss_col = torch.where(_col(last_spec_in), sunsky_v, sky_v)
        color = color + torch.where(_col(hit), torch.zeros_like(color),
                                    rays["direct"] * miss_col)

        # connect: the shadow ray against every triangle and sphere
        maxd = torch.where(shadow_ok, shadow_maxd,
                           torch.zeros_like(shadow_maxd))
        occluded = occluded_by_triangles(o, shadow_dir, maxd, sc.vert, sc.e1,
                                         sc.e2)
        t_sh = ray_sphere(o[:, None, :], shadow_dir[:, None, :],
                          sc.center[None], sc.radius[None])
        occluded = occluded | ((t_sh > 0.0)
                               & ((t_sh + EPSILON) < maxd[:, None])).any(1)
        shadow_contrib = torch.where(_col(shadow_ok & ~occluded), shadow_color,
                                     torch.zeros_like(shadow_color))
        flush = rays["pending"] + (color + shadow_contrib)
        samples_lights = is_diff | is_phong | is_fog
        return dict(survive=survive, origin=origin_out, direction=new_dir,
                    direct=direct_out, pending=flush, pixel=pixel,
                    bounces=bounces + 1, last_specular=new_last_spec,
                    shadow_valid=shadow_ok, is_fog=is_fog, pick=pick,
                    nee_light=samples_lights & ~choose_sun)


def make_step(scene_kw: dict, config: dict, render: dict, device,
              dtype=torch.float32) -> Step:
    """The reference's step of the configuration: the arrays a scene
    generator made (``scene_kw``, the keyword arguments of the program's
    ``Scene.from_triangles``: ``v0``, ``v1``, ``v2``, ``spheres``,
    ``tri_refl``, ``tri_color`` and ``delta_lights``, read by their
    arrays) under the configuration's sun, for the ``render`` fields, in
    ``dtype``.  Anything else it does not shade raises: another scene
    table, fog off, MIS, a uniform pick or the Sobol sampler."""
    extra = sorted(set(scene_kw) - {"v0", "v1", "v2", "spheres", "tri_refl",
                                    "tri_color", "delta_lights"})
    if extra:
        raise ValueError(f"the reference shades no {', '.join(extra)}")
    want = {"fog": "on", "mis": "off", "light_sampling": "power",
            "sampler": "xorshift"}
    for key, value in want.items():
        if render.get(key, "xorshift" if key == "sampler" else None) != value:
            raise ValueError(f"the reference shades {key} {value!r} only")
    sc = Scene(scene_kw, config["scene"]["sun_position"], device, dtype)
    return Step(sc, render)
