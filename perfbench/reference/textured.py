"""The plain reference of the textured configuration's render step: one
wavefront iteration for chosen queue slots, in plain PyTorch, with no BVH
and no texture atlas.

It reimplements, from the scene generator's own arrays and source images
(``perfbench/scenes/textured.py``), camera pose and sun, what the
program's step computes for a slot on a textured scene: the camera ray
of a fresh slot, the closest hit against every triangle (Möller-Trumbore
with back-face culling, by brute force, in chunks) and every sphere, and
the shade of the textured surface:

- each triangle's uvs and tangent frame (the uv tangent orthonormalised
  against the geometric normal, its handedness) interpolated at the hit
  by the dual basis of the triangle's edges;
- bilinear taps of the albedo (with its cutout alpha), the tangent-space
  normal map and the roughness/metal map, each with its wrap (repeat,
  clamp to edge, mirrored repeat), read from the generator's images;
- the normal map composed after the geometric normal, the roughness from
  its map, and the metal map's GGX-or-diffuse pick on its own stream;
- the pass-through of a cutout hit below alpha 0.5, or of a blend hit
  below a uniform from its own stream (0xB1E2D): no shading, no NEE, no
  colour, the ray goes on behind the surface;
- the GGX conductor's sun and light NEE and its VNDF bounce;

besides the default materials of the spheres (DIFF, SPEC, REFR, PHONG,
LIGHT), sun and sphere-light next-event estimation, Russian roulette, the
shadow ray's alpha-blind any-hit against every triangle and sphere, and
what the slot adds to its pixel when its path ends.  Random numbers come
from the same stateless xorshift streams, keyed by (frame, pixel, slot).

The functions are frozen copies of the program's arithmetic for those
features (``render.py``, ``scene/scene.py``'s attribute rows,
``ops/rng.py``, ``ops/sampling.py``, ``ops/intersect.py``, ``sky.py`` at
the commit this reference was written against; the helpers it shares
with ``pathtracer.py`` are copied from there, since a reference is loaded
by its path, outside any package), restricted to the configuration's
settings: perspective camera, xorshift sampler, bilinear filtering, one
emissive sphere, no MIS, fog, smooth normals, dispersion or clamp.  Every
float tensor is in ``dtype``, so the same code computed in bfloat16 is the
configuration's lower-precision control.  Nothing of the program is
imported.

Tolerances: none is applied here.  The comparison (``perfbench/check.py``)
holds each pixel's accumulation delta and carried rays to float32
rounding with a wide margin (1e-3 relative): the program taps a packed
copy of the same images and interpolates with the same float32 operations,
so what separates the two sides is the hit distance of the BVH walk
against the brute force (a few ulps of t, moving uv by about 1e-7 of a
repeat) and the order of a few sums.  A cutout or metal decision can flip
only where a filtered value lies within that of its threshold, which a
sample of tens of thousands of slots almost never meets.
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
MATERIALS = {"DIFF": DIFF, "SPEC": SPEC, "REFR": REFR, "PHONG": PHONG,
             "LIGHT": LIGHT}

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

# ray-triangle pairs a chunk of the brute force: few launches on the card,
# a chunk that stays in cache on the CPU (4x faster there at 2^20)
BRUTE_PAIRS = {"cuda": 1 << 25, "cpu": 1 << 20}

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

    def sphere_surface(self, center, radius, seed):
        seed, u = self.f(seed)
        seed, v = self.f(seed)
        cos_phi = 2.0 * u - 1.0
        sin_phi = torch.sqrt(torch.clamp(1.0 - cos_phi * cos_phi, min=0.0))
        theta = 2.0 * PI * v
        offset = torch.stack([sin_phi * torch.sin(theta), cos_phi,
                              sin_phi * torch.cos(theta)], dim=-1)
        return seed, center + radius * offset

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


def _chunks(n, n_tri, device):
    pairs = BRUTE_PAIRS.get(torch.device(device).type, BRUTE_PAIRS["cuda"])
    step = max(1, pairs // max(n_tri, 1))
    return range(0, n, step), step


def closest_triangle(origin, direction, vert, e1, e2):
    """(t, index) of the nearest front-face triangle beyond epsilon, over
    every triangle; VERY_FAR and -1 on a miss."""
    n = origin.shape[0]
    t = torch.full((n,), VERY_FAR, dtype=origin.dtype, device=origin.device)
    idx = torch.full((n,), -1, dtype=torch.int64, device=origin.device)
    starts, step = _chunks(n, vert.shape[0], origin.device)
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
    starts, step = _chunks(n, vert.shape[0], origin.device)
    for s in starts:
        t_all = moller_trumbore(origin[s:s + step, None], direction[s:s + step,
                                                                    None],
                                vert[None], e1[None], e2[None])
        lim = max_dist[s:s + step, None]
        occ[s:s + step] = ((t_all > EPSILON)
                           & ((lim - t_all) > EPSILON)).any(1)
    return occ


# --------------------------------------------------------------------------
# the scene, the camera and one step
# --------------------------------------------------------------------------

class Scene:
    """The reference's scene on ``device`` in ``dtype``: the triangles
    (v0, e1 = v1 - v0, e2 = v2 - v0, taken in float32 as given), the
    spheres (rows of the configuration: radius, center, color, emission,
    material name), the sun and the sky."""

    def __init__(self, v0, v1, v2, spheres, sun_position, device,
                 dtype=torch.float32):
        v0 = np.asarray(v0, np.float32)
        e1 = np.asarray(v1, np.float32) - v0
        e2 = np.asarray(v2, np.float32) - v0

        def t(a):
            return torch.as_tensor(np.asarray(a, np.float32),
                                   device=device).to(dtype)
        self.device, self.dtype = torch.device(device), dtype
        self.vert, self.e1, self.e2 = t(v0), t(e1), t(e2)
        self.center = t([s["center"] for s in spheres])
        self.radius = t([s["radius"] for s in spheres])
        self.color = t([s["color"] for s in spheres])
        self.emission = t([s["emission"] for s in spheres])
        refl = [MATERIALS[s["material"]] for s in spheres]
        self.refl = torch.tensor(refl, dtype=torch.int32, device=device)
        lights = [i for i, r in enumerate(refl) if r == LIGHT]
        if len(lights) != 1:
            raise ValueError("the reference shades exactly one emissive "
                             f"sphere; the configuration has {len(lights)}")
        self.light = lights[0]
        self.sun_dir = sun_direction(sun_position, device, dtype)
        self.sky = Sky(device, dtype)


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
# the textured surface
# --------------------------------------------------------------------------

GGX, PASS = 5, 7          # the program's GGX material and pass-through
REPEAT, CLAMP, MIRROR = 0, 1, 2   # wrap modes
ALPHA_CUTOFF = 0.5        # glTF's default alphaCutoff
BLEND_KEY = 0xB1E2D       # the blend coin's stream
METAL_KEY = 0x4E7A1       # the metal pick's stream
BLEND_U_MARGIN = 1e-6     # the blend coin kept inside (0, 1)
ROUGH_MIN, ROUGH_MAX = 0.03, 1.0   # the perceptual roughness's clamp
SPHERE_ROUGHNESS = 0.3    # Spheres' default (no GGX sphere here)
SCENE_KEYS = ("v0", "v1", "v2", "spheres", "tri_uv", "tri_tex", "tri_ntex",
              "tri_rtex", "tri_refl", "tri_metal", "tri_blend", "tri_color",
              "tri_rough", "textures", "texture_wraps")


def ggx_d_vec(normal, h, alpha):
    """GGX D(h) from the vectors: sin^2 from the cross product."""
    cr = cross(normal, h)
    sin2 = dot(cr, cr)
    a2 = alpha * alpha
    c = sin2 + a2 * torch.clamp(1.0 - sin2, min=0.0)
    return a2 / torch.clamp(PI * c * c, min=1e-12)


def ggx_g1(n_dot_x, alpha):
    """Smith GGX masking G1 of one direction; 0 below the horizon."""
    a2 = alpha * alpha
    nx = torch.clamp(n_dot_x, min=0.0)
    return 2.0 * nx / torch.clamp(
        nx + torch.sqrt(a2 + (1.0 - a2) * nx * nx), min=1e-12)


def ggx_eval(normal, view, light_dir, alpha, f0):
    """The single-scatter GGX BRDF f(v, l) [n, 3]: separable Smith G2,
    Schlick Fresnel from ``f0``."""
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


def ggx_vndf(view, normal, alpha, u1, u2):
    """A GGX half-vector from the distribution of visible normals (Heitz
    2018) around the face-forwarded ``normal``, from uniforms u1, u2."""
    tu, tv = orthonormal_basis(normal)
    vx = dot(view, tu)
    vy = dot(view, tv)
    vz = dot(view, normal)
    h = torch.stack([alpha * vx, alpha * vy, vz], -1)
    h = h / torch.sqrt(torch.clamp(dot(h, h), min=1e-20))[..., None]
    lensq = h[..., 0] * h[..., 0] + h[..., 1] * h[..., 1]
    inv_len = 1.0 / torch.sqrt(torch.clamp(lensq, min=1e-20))
    ex = torch.tensor((1.0, 0.0, 0.0), dtype=h.dtype, device=h.device)
    t1 = torch.where((lensq > 1e-16)[..., None],
                     torch.stack([-h[..., 1] * inv_len, h[..., 0] * inv_len,
                                  torch.zeros_like(inv_len)], -1),
                     ex.expand_as(h))
    t2 = cross(h, t1)
    r = torch.sqrt(torch.clamp(u1, min=0.0))
    phi = 2.0 * PI * u2
    p1 = r * torch.cos(phi)
    p2 = r * torch.sin(phi)
    s = 0.5 * (1.0 + h[..., 2])
    p2 = (1.0 - s) * torch.sqrt(torch.clamp(1.0 - p1 * p1, min=0.0)) + s * p2
    pz = torch.sqrt(torch.clamp(1.0 - p1 * p1 - p2 * p2, min=0.0))
    nh = p1[..., None] * t1 + p2[..., None] * t2 + pz[..., None] * h
    m = torch.stack([alpha * nh[..., 0], alpha * nh[..., 1],
                     torch.clamp(nh[..., 2], min=0.0)], -1)
    m = m / torch.sqrt(torch.clamp(dot(m, m), min=1e-20))[..., None]
    return m[..., 0:1] * tu + m[..., 1:2] * tv + m[..., 2:3] * normal


class Maps:
    """The generator's images [H, W, C] (row 0 at the top, v = 0 at the
    bottom) on ``device`` in ``dtype``, a missing alpha channel 1, and
    each image's (wrap_s, wrap_t)."""

    def __init__(self, images, wraps, device, dtype):
        self.images = []
        for im in images:
            im = np.asarray(im, np.float32)
            rgba = np.ones(im.shape[:2] + (4,), np.float32)
            rgba[..., :im.shape[2]] = im[..., :4]
            self.images.append(torch.as_tensor(rgba, device=device).to(dtype))
        self.wraps = [tuple(int(m) for m in w) for w in wraps]
        # with any non-repeat wrap the program wraps every texture by its
        # own mode; without, by the repeat's arithmetic alone
        self.any_wrap = any(ws or wt for ws, wt in self.wraps)

    @staticmethod
    def _wrap(c, mode: int):
        if mode == CLAMP:
            return torch.clamp(c, 0.0, 1.0)
        if mode == MIRROR:
            t2 = c - 2.0 * torch.floor(c * 0.5)
            return torch.where(t2 > 1.0, 2.0 - t2, t2)
        return c - torch.floor(c)

    def _bilinear(self, k: int, u, v):
        """Four half-texel centred taps of image ``k`` at (u, v) [m]: RGBA
        [m, 4]; a non-repeat border clamps the neighbour texel."""
        img = self.images[k]
        h, w = img.shape[0], img.shape[1]
        ws, wt = self.wraps[k] if self.any_wrap else (REPEAT, REPEAT)
        u, v = self._wrap(u, ws), self._wrap(v, wt)
        fx = u * w - 0.5
        fy = v * h - 0.5
        x0f = torch.floor(fx)
        y0f = torch.floor(fy)
        ax = _col(fx - x0f)
        ay = _col(fy - y0f)
        xi, yi = x0f.to(torch.int64), y0f.to(torch.int64)
        if ws == REPEAT:
            x0 = torch.remainder(xi, w)
            x1 = torch.remainder(x0 + 1, w)
        else:
            x0 = torch.clamp(xi, 0, w - 1)
            x1 = torch.clamp(x0 + 1, max=w - 1)
        if wt == REPEAT:
            y0 = torch.remainder(yi, h)
            y1 = torch.remainder(y0 + 1, h)
        else:
            y0 = torch.clamp(yi, 0, h - 1)
            y1 = torch.clamp(y0 + 1, max=h - 1)

        def tap(x, y):
            return img[h - 1 - y, x]
        return (tap(x0, y0) * (1 - ax) * (1 - ay)
                + tap(x1, y0) * ax * (1 - ay)
                + tap(x0, y1) * (1 - ax) * ay
                + tap(x1, y1) * ax * ay)

    def sample(self, texid, u, v):
        """Bilinear RGBA [n, 4] at (u, v) [n] of image ``texid`` [n]; 1
        where ``texid`` is -1."""
        out = torch.ones(texid.shape + (4,), dtype=u.dtype, device=u.device)
        for k in range(len(self.images)):
            sel = texid == k
            if bool(sel.any()):
                out[sel] = self._bilinear(k, u[sel], v[sel])
        return out


class Surfaces:
    """Per-triangle shading records in the generator's triangle order, as
    the program's packer derives them (``scene/scene.py``: tri_shade's
    material, colour and clamped roughness with the blend and metal
    flags under their gates; tri_attr's dual basis of the edges, corner
    uvs, map ids and uv tangent with its handedness), and the maps."""

    def __init__(self, kw: dict, device, dtype):
        v0 = np.asarray(kw["v0"], np.float32)
        e1 = (np.asarray(kw["v1"], np.float32) - v0).astype(np.float64)
        e2 = (np.asarray(kw["v2"], np.float32) - v0).astype(np.float64)
        n_tri = v0.shape[0]
        refl = np.asarray(kw["tri_refl"], np.int32)
        if not set(np.unique(refl).tolist()) <= {DIFF, GGX}:
            raise ValueError("the reference shades DIFF and GGX triangles "
                             "only")
        images = list(kw["textures"])
        uv = np.asarray(kw["tri_uv"], np.float32)            # [T, 3, 2]

        def ids(key):
            return np.asarray(kw[key], np.int32)
        tex, ntex, rtex = ids("tri_tex"), ids("tri_ntex"), ids("tri_rtex")
        # the program's gates
        self.has_tex = bool((tex >= 0).any())
        has_nmap, has_rmap = bool((ntex >= 0).any()), bool((rtex >= 0).any())
        self.has_alpha = self.has_tex and any(
            im.shape[2] >= 4 and bool((im[..., 3] < 1.0).any())
            for im in map(np.asarray, images))
        blend = np.asarray(kw["tri_blend"], bool)
        self.has_blend = self.has_alpha and bool(blend.any())
        metal = np.asarray(kw["tri_metal"], bool) & (refl == GGX)
        self.has_metal = has_rmap and bool(metal.any())

        # the dual basis of the edges: barycentrics with two dots
        d11 = np.sum(e1 * e1, axis=1)
        d22 = np.sum(e2 * e2, axis=1)
        d12 = np.sum(e1 * e2, axis=1)
        det = np.maximum(d11 * d22 - d12 * d12, 1e-30)
        s1 = (d22[:, None] * e1 - d12[:, None] * e2) / det[:, None]
        s2 = (d11[:, None] * e2 - d12[:, None] * e1) / det[:, None]
        # the uv tangent T = (dv2 e1 - dv1 e2) / det and the bitangent's
        # handedness; a degenerate uv map disables the normal map
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
        handed = np.where(
            np.sum(np.cross(np.cross(e1, e2), tang) * bitan, axis=1) >= 0.0,
            1.0, -1.0)

        def f(a):
            return torch.as_tensor(np.asarray(a, np.float32),
                                   device=device).to(dtype)

        def i(a):
            return torch.as_tensor(np.asarray(a, np.int32), device=device)
        self.refl = i(refl)
        self.color = f(kw["tri_color"])
        self.rough = f(np.clip(np.asarray(kw["tri_rough"], np.float32),
                               ROUGH_MIN, ROUGH_MAX))
        self.blend = torch.as_tensor(blend & self.has_blend, device=device)
        self.metal = torch.as_tensor(metal & self.has_metal, device=device)
        self.v0, self.s1, self.s2 = f(v0), f(s1), f(s2)
        self.uv0 = f(uv[:, 0])
        self.duv1, self.duv2 = f(uv[:, 1] - uv[:, 0]), f(uv[:, 2] - uv[:, 0])
        self.tex = i(tex if self.has_tex else np.full(n_tri, -1))
        self.ntex = i(np.where(ok_uv, ntex, -1) if has_nmap
                      else np.full(n_tri, -1))
        self.rtex = i(rtex if has_rmap else np.full(n_tri, -1))
        self.tang, self.handed = f(tang), f(handed)
        self.maps = Maps(images, kw["texture_wraps"], device, dtype)

    def fetch(self, tid, p, normal_tri, frame_s: int, pixel, slots):
        """The surface of triangle ``tid`` [n] at the (pre-offset) hit
        point ``p``: (the normal-mapped normal, the material after the
        metal pick, the albedo-tinted colour, the mapped roughness, the
        cutout alpha, the blend flag)."""
        bu = dot(p - self.v0[tid], self.s1[tid])
        bv = dot(p - self.v0[tid], self.s2[tid])
        uv = self.uv0[tid] + _col(bu) * self.duv1[tid] \
            + _col(bv) * self.duv2[tid]
        u, v = uv[:, 0], uv[:, 1]
        texid = self.tex[tid]
        albedo = self.maps.sample(texid, u, v)
        color = self.color[tid] * torch.where(_col(texid >= 0),
                                              albedo[:, :3], 1.0)
        cut_alpha = torch.where(texid >= 0, albedo[:, 3], 1.0) \
            if self.has_alpha else torch.ones_like(u)

        # the tangent-space normal map after the geometric normal
        ntexid = self.ntex[tid]
        n_ts = self.maps.sample(ntexid, u, v)[:, :3] * 2.0 - 1.0
        tang = self.tang[tid]
        t_o = tang - normal_tri * _col(dot(normal_tri, tang))
        t_len = torch.sqrt(torch.clamp(dot(t_o, t_o), min=1e-20))
        t_o = t_o / _col(t_len)
        b_o = cross(normal_tri, t_o) * _col(self.handed[tid])
        n_p = t_o * n_ts[:, 0:1] + b_o * n_ts[:, 1:2] \
            + normal_tri * torch.clamp(n_ts[:, 2:3], min=0.0)
        n_p = n_p / _col(torch.sqrt(torch.clamp(dot(n_p, n_p), min=1e-20)))
        normal = torch.where(_col((ntexid >= 0) & (t_len > 1e-6)), n_p,
                             normal_tri)

        # roughness (channel 0) and metalness (channel 1): the conductor
        # with the metalness's probability, else DIFF
        rtexid = self.rtex[tid]
        rrow = self.maps.sample(rtexid, u, v)
        rough = torch.where(rtexid >= 0,
                            torch.clamp(rrow[:, 0], ROUGH_MIN, ROUGH_MAX),
                            self.rough[tid])
        refl = self.refl[tid]
        metal = self.metal[tid]
        _, u_m = random_float(seed_from(frame_s, pixel, slots, 0, METAL_KEY))
        m_tex = torch.where(rtexid >= 0, rrow[:, 1], 1.0)
        refl = torch.where(metal & (u_m < m_tex), GGX,
                           torch.where(metal, DIFF, refl))
        return normal, refl, color, rough, cut_alpha, self.blend[tid]


# --------------------------------------------------------------------------
# one step
# --------------------------------------------------------------------------

class Step:
    """One wavefront step of the configuration for chosen queue slots.

    ``cfg``: width, height, num_rays, max_bounces, seed (the run's
    RenderConfig.seed), focal_distance_scale."""

    def __init__(self, scene: Scene, surfaces: Surfaces, cfg: dict):
        self.sc = scene
        self.surf = surfaces
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

    def run(self, rays: dict, slots, frame_s: int):
        """Extend, shade (with the textured surface), connect and roulette
        for ``rays`` (origin, direction, direct, pending [n, 3]; pixel,
        bounces [n]; last_specular [n] bool) at queue ``slots``.  Returns
        the per-ray outcome: survive, the next ray's fields, the flush
        (pending plus this bounce's contribution, which a ray that ends
        adds to its pixel) and whether the slot traced a valid shadow ray.
        """
        sc, sf, cfg, dr = self.sc, self.surf, self.cfg, self.draw
        eps = EPSILON
        d = rays["direction"]
        pixel, bounces = rays["pixel"], rays["bounces"]
        last_spec_in = rays["last_specular"]
        t, sph, tri = self.trace(rays["origin"], d)

        hit = t < VERY_FAR
        is_tri = tri >= 0
        t_safe = torch.where(hit, t, torch.zeros_like(t))
        o = rays["origin"] + d * _col(t_safe)
        is_sphere = hit & (sph >= 0)
        sid = torch.clamp(sph, min=0)
        normal_sphere = (o - sc.center[sid]) / _col(sc.radius[sid])
        tid = torch.clamp(tri, min=0)
        tn = cross(sc.e1[tid], sc.e2[tid])
        normal_tri = tn / _col(torch.sqrt(torch.clamp(dot(tn, tn), min=1e-30)))
        (normal_tri, refl_tri, color_tri, rough_tri, cut_alpha,
         blend_tri) = sf.fetch(tid, o, normal_tri, frame_s, pixel, slots)
        normal = torch.where(_col(is_sphere), normal_sphere, normal_tri)
        refl = torch.where(is_sphere, sc.refl[sid], refl_tri)
        refl = torch.where(hit, refl, DIFF)
        obj_color = torch.where(_col(is_sphere), sc.color[sid], color_tri)

        # the cutout: a hit below its threshold (0.5, or on a blend
        # triangle a uniform of its own stream) passes through
        thresh = ALPHA_CUTOFF
        if sf.has_blend:
            _, u_b = random_float(seed_from(frame_s, pixel, slots, 0,
                                            BLEND_KEY))
            thresh = torch.where(blend_tri, torch.clamp(
                u_b, BLEND_U_MARGIN, 1.0 - BLEND_U_MARGIN), ALPHA_CUTOFF)
        is_pass = hit & is_tri & (cut_alpha < thresh)
        refl = torch.where(is_pass, PASS, refl)

        # throughput *= colour, except glass, emitters, pass-throughs and
        # GGX (whose colour is its Fresnel F0)
        mul_mask = hit & (refl != REFR) & (refl != LIGHT) & (refl != PASS) \
            & (refl != GGX)
        ggx_rough = torch.where(is_sphere, SPHERE_ROUGHNESS, rough_tri)
        is_ggx = hit & (refl == GGX)
        ggx_alpha = ggx_rough * ggx_rough
        direct = rays["direct"] * torch.where(_col(mul_mask), obj_color,
                                              torch.ones_like(obj_color))
        outside = dot(normal, d) < 0
        normal = torch.where(_col(outside), normal, -normal)
        o = o + normal * eps

        # an emitter hit counts on specular-born paths (NEE counted the
        # others) and stops the throughput of diffuse-born ones
        is_light = hit & (refl == LIGHT)
        emission = sc.emission[sid]
        color = torch.where(_col(is_light & last_spec_in), direct * emission,
                            torch.zeros_like(direct))
        direct = torch.where(_col(is_light & ~last_spec_in),
                             torch.zeros_like(direct), direct)

        # next-event estimation: the sun cone or the light sphere, by coin
        seed = seed_from(frame_s, pixel, slots, 0, 0x5ADE)
        n = o.shape[0]
        sun_dir = sc.sun_dir
        seed, sun_sample = dr.cone(sun_dir.expand(n, 3), 1.0 - SUN_COS, seed)
        sun_cos = dot(normal, sun_sample)
        _, cs_u = random_float(seed_from(frame_s, pixel, slots, 0, 0xC0F1))
        choose_sun = cs_u < 0.5
        inv_p_sun = inv_p_light = 2.0
        li = sc.light
        light_c, light_r = sc.center[li], sc.radius[li]
        light_e = sc.emission[li]
        seed, lp = dr.sphere_surface(light_c.expand(n, 3), light_r, seed)
        n_l = normalize(lp - light_c)
        area = 4.0 * PI * light_r * light_r
        lvec = lp - o
        ldist2 = dot(lvec, lvec)
        ldist = torch.sqrt(torch.clamp(ldist2, min=1e-20))
        ldir = lvec / _col(ldist)
        cos_surf = dot(normal, ldir)
        cos_light = dot(n_l, -ldir)
        solid_angle = cos_light * area / torch.clamp(ldist2, min=1e-20)

        sun_radiance = sc.sky.sun(sun_sample, sun_dir)
        c_diff = c_spec = 1e-5
        diff_sun_color = inv_p_sun * direct * sun_radiance \
            * _col(sun_cos * c_diff)
        diff_sun_ok = choose_sun & (sun_cos > 0)
        nl = inv_p_light * 1.0
        diff_light_color = light_e[None] * nl * direct \
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
        phong_light_color = light_e[None] * nl * direct \
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
        # the GGX conductor: the same estimators with the microfacet BRDF
        # toward each sample, its F0 the surface colour
        view = -d
        f_ggx_sun = ggx_eval(normal, view, sun_sample, ggx_alpha, obj_color)
        ggx_sun_color = inv_p_sun * direct * sun_radiance * f_ggx_sun \
            * _col(sun_cos * c_spec)
        f_ggx_l = ggx_eval(normal, view, ldir, ggx_alpha, obj_color)
        ggx_light_color = light_e[None] * nl * direct * f_ggx_l \
            * _col(solid_angle * cos_surf)
        ggx_sun_ok = choose_sun & (sun_cos > 0)
        ggx_light_ok = ~choose_sun & (cos_surf > 0) & (cos_light > 0)
        shadow_ok = shadow_ok | (is_ggx & (ggx_sun_ok | ggx_light_ok))
        shadow_color = torch.where(
            _col(is_ggx), torch.where(sun_c, ggx_sun_color, ggx_light_color),
            shadow_color)
        shadow_maxd = torch.where(choose_sun, torch.full_like(ldist, VERY_FAR),
                                  ldist)

        # the bounce: DIFF cosine lobe, SPEC mirror, REFR Fresnel/TIR with
        # Beer-Lambert, PHONG lobe with rejection, GGX VNDF lobe from its
        # own stream; a pass-through keeps its direction
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
        gseed = seed_from(frame_s, pixel, slots, 0, 0x66C5)
        gseed, gu1 = dr.f(gseed)
        _, gu2 = dr.f(gseed)
        ggx_h = ggx_vndf(view, normal, ggx_alpha, gu1, gu2)
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
        new_last_spec = (hit & (refl == SPEC)) | (is_refr & refr_reflects)
        new_last_spec = torch.where(is_pass, last_spec_in, new_last_spec)
        zero = torch.zeros_like(normal)
        origin_out = o \
            + torch.where(_col(is_refr & ~refr_reflects), -2.0 * eps * normal,
                          zero) \
            + torch.where(_col(is_phong), eps * w_refl, zero)
        # a pass-through steps through the surface (the face-forward
        # offset would hit it again)
        origin_out = origin_out + torch.where(_col(is_pass),
                                              -2.0 * eps * normal, zero)

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

        # connect: the shadow ray against every triangle (alpha-blind) and
        # sphere
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
        return dict(survive=survive, origin=origin_out, direction=new_dir,
                    direct=direct_out, pending=flush, pixel=pixel,
                    bounces=bounces + 1, last_specular=new_last_spec,
                    shadow_valid=shadow_ok)


def make_step(scene_kw: dict, config: dict, render: dict, device,
              dtype=torch.float32) -> Step:
    """The reference's step of the textured configuration: the triangles,
    materials, uvs, maps and spheres a scene generator made (``scene_kw``,
    the keyword arguments of the program's ``Scene.from_triangles``, read
    by their arrays) under the configuration's sun, for the ``render``
    fields, in ``dtype``.  A scene with anything else (smooth normals, an
    environment map, triangle lights, glass IORs, delta lights), or a
    filter other than bilinear, raises: this reference shades none of
    it."""
    extra = sorted(set(scene_kw) - set(SCENE_KEYS))
    if extra:
        raise ValueError(f"the reference shades no {', '.join(extra)}")
    if render.get("texture_filter", "bilinear") != "bilinear":
        raise ValueError("the reference taps its maps bilinearly; the "
                         f"configuration asks for {render['texture_filter']}")
    sph = scene_kw["spheres"]
    names = {v: k for k, v in MATERIALS.items()}
    rows = [{"center": c, "radius": r, "color": k, "emission": e,
             "material": names[int(m)]}
            for c, r, k, e, m in zip(sph.center, sph.radius, sph.color,
                                     sph.emission, sph.refl)]
    if sph.roughness is not None:
        raise ValueError("the reference gives every sphere roughness 0.3")
    sc = Scene(scene_kw["v0"], scene_kw["v1"], scene_kw["v2"], rows,
               config["scene"]["sun_position"], device, dtype)
    return Step(sc, Surfaces(scene_kw, device, dtype), render)
