"""Sampling primitives, the port of ``tyrant_tpu/ops/sampling.py`` for the
functions the render step uses.  Vectors are ``[..., 3]`` float32 tensors."""

from __future__ import annotations

import torch

from ..config import PI
from ..device import constant

from . import rng


def dot(a, b):
    return (a * b).sum(-1)


def normalize(v, eps: float = 1e-20):
    return v / torch.sqrt(torch.clamp(dot(v, v), min=eps))[..., None]


def cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def reflect(d, n):
    """d - 2*dot(d,n)*n."""
    return d - 2.0 * dot(d, n)[..., None] * n


def orthonormal_basis(w):
    """(u, v) completing ``w`` to an orthonormal basis: the Y axis when
    |w.x| > 0.9, else the X axis, then Gram-Schmidt."""
    pick_y = torch.abs(w[..., 0]) > 0.9
    ey = constant((0.0, 1.0, 0.0), w.device, w.dtype)
    ex = constant((1.0, 0.0, 0.0), w.device, w.dtype)
    a = torch.where(pick_y[..., None], ey, ex).expand_as(w)
    u = normalize(cross(a, w))
    v = cross(w, u)
    return u, v


def ortho(v):
    """Any vector orthogonal-ish to v."""
    use_x = torch.abs(v[..., 0]) > torch.abs(v[..., 2])
    zero = torch.zeros_like(v[..., 0])
    o_a = torch.stack([-v[..., 1], v[..., 0], zero], -1)
    o_b = torch.stack([zero, -v[..., 2], v[..., 1]], -1)
    return torch.where(use_x[..., None], o_a, o_b)


def concentric_sample_disk(u):
    """Map [0,1]^2 onto the unit disk, concentric (lens sampling)."""
    off = 2.0 * u - 1.0
    ox, oy = off[..., 0], off[..., 1]
    degenerate = (ox == 0) & (oy == 0)
    x_major = torch.abs(ox) > torch.abs(oy)
    safe_ox = torch.where(ox == 0, torch.ones_like(ox), ox)
    safe_oy = torch.where(oy == 0, torch.ones_like(oy), oy)
    r = torch.where(x_major, ox, oy)
    theta = torch.where(x_major,
                        (PI / 4) * (oy / safe_ox),
                        (PI / 2) - (PI / 4) * (ox / safe_oy))
    pt = r[..., None] * torch.stack([torch.cos(theta), torch.sin(theta)], -1)
    return torch.where(degenerate[..., None], torch.zeros_like(pt), pt)


def polygon_sample_disk(u, blades: int, rotation: float = 0.0):
    """[0, 1]^2 onto a regular ``blades``-gon inscribed in the unit disk,
    uniformly (a polygonal aperture; blades >= 3): the sector from u0's
    high part, the point in its triangle from (u0's remainder, u1) with
    the fold; ``rotation`` in radians."""
    nb = float(blades)
    u0, u1 = u[..., 0], u[..., 1]
    k = torch.clamp((u0 * nb).to(torch.int32), max=blades - 1)
    a = u0 * nb - k.to(torch.float32)
    b = u1
    flip = a + b > 1.0
    a = torch.where(flip, 1.0 - a, a)
    b = torch.where(flip, 1.0 - b, b)
    t0 = (2.0 * PI / nb) * k.to(torch.float32) + rotation
    t1 = t0 + 2.0 * PI / nb
    v0 = torch.stack([torch.cos(t0), torch.sin(t0)], -1)
    v1 = torch.stack([torch.cos(t1), torch.sin(t1)], -1)
    return a[..., None] * v0 + b[..., None] * v1


def cone_sample(direction, extent, seed):
    """Uniform sample inside a cone around ``direction`` (sun NEE).
    Returns (new_seed, sample_direction)."""
    seed, rx = rng.random_float2(seed)
    seed, ry = rng.random_float2(seed)
    return seed, cone_sample_from_uniforms(direction, extent, rx, ry)


def cone_sample_from_uniforms(direction, extent, rx, ry):
    """The mapping of :func:`cone_sample` from two uniforms (the Sobol
    draws' call sites)."""
    d = normalize(direction)
    o1 = normalize(ortho(d))
    o2 = normalize(cross(d, o1))
    phi = rx * 2.0 * PI
    z = 1.0 - ry * extent
    oneminus = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    return (torch.cos(phi) * oneminus)[..., None] * o1 \
        + (torch.sin(phi) * oneminus)[..., None] * o2 \
        + z[..., None] * d


def hg_phase(cos_theta, g: float):
    """Henyey-Greenstein phase function, equal to its solid-angle pdf
    (normalised over the sphere); ``g`` is the config's float (the fog
    medium's anisotropy).  The atmosphere keeps its own HG (sky.py)."""
    if abs(g) < 1e-4:
        return torch.full_like(cos_theta, 1.0 / (4.0 * PI))
    denom = torch.clamp(1.0 + g * g - 2.0 * g * cos_theta, min=1e-12)
    return (1.0 - g * g) / (4.0 * PI * denom * torch.sqrt(denom))


def hg_sample_from_uniforms(direction, g: float, u1, u2):
    """A direction from the HG phase function around ``direction``: the
    exact inverse CDF in cos(theta), so its pdf is :func:`hg_phase`."""
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


def sphere_surface_sample(center, radius, seed):
    """Uniform point on a sphere surface (area light sampling; y gets
    cos(phi), x/z the sine terms).  Returns (new_seed, point)."""
    seed, u = rng.random_float(seed)
    seed, v = rng.random_float(seed)
    return seed, sphere_surface_from_uniforms(center, radius, u, v)


def sphere_surface_from_uniforms(center, radius, u, v):
    """The mapping of :func:`sphere_surface_sample` from two uniforms
    (the multi-light pick feeds one pair to whichever shape it picked)."""
    cos_phi = 2.0 * u - 1.0
    sin_phi = torch.sqrt(torch.clamp(1.0 - cos_phi * cos_phi, min=0.0))
    theta = 2.0 * PI * v
    offset = torch.stack([sin_phi * torch.sin(theta), cos_phi,
                          sin_phi * torch.cos(theta)], dim=-1)
    return center + radius * offset


def triangle_sample_from_uniforms(v0, e1, e2, u, v):
    """Uniform point on a triangle (square-root warp): v0 + b1 e1 + b2 e2
    with b1 = 1 - sqrt(u), b2 = v sqrt(u)."""
    su = torch.sqrt(torch.clamp(u, min=0.0))
    b1 = 1.0 - su
    b2 = v * su
    return v0 + b1[..., None] * e1 + b2[..., None] * e2


def cosine_hemisphere_sample(normal, seed):
    """Cosine-weighted hemisphere direction around ``normal``.
    Returns (new_seed, direction)."""
    seed, r1u = rng.random_float(seed)
    seed, r2 = rng.random_float(seed)
    return seed, cosine_hemisphere_from_uniforms(normal, r1u, r2)


def cosine_hemisphere_from_uniforms(normal, r1u, r2):
    """The mapping of :func:`cosine_hemisphere_sample` from two
    uniforms."""
    r1 = 2.0 * PI * r1u
    r2s = torch.sqrt(r2)
    u, v = orthonormal_basis(normal)
    d = u * (torch.cos(r1) * r2s)[..., None] \
        + v * (torch.sin(r1) * r2s)[..., None] \
        + normal * torch.sqrt(torch.clamp(1.0 - r2, min=0.0))[..., None]
    return normalize(d)


def phong_lobe_sample(w, phong_exponent, seed):
    """Sample around the ideal reflection ``w`` with a cos^n lobe.
    Returns (new_seed, direction)."""
    seed, phi_u = rng.random_float(seed)
    seed, r2 = rng.random_float(seed)
    phi = 2.0 * PI * phi_u
    cos_theta = torch.pow(torch.clamp(1.0 - r2, min=0.0),
                          1.0 / (phong_exponent + 1.0))
    sin_theta = torch.sqrt(torch.clamp(1.0 - cos_theta * cos_theta, min=0.0))
    u, v = orthonormal_basis(w)
    d = u * (torch.cos(phi) * sin_theta)[..., None] \
        + v * (torch.sin(phi) * sin_theta)[..., None] \
        + w * cos_theta[..., None]
    return seed, normalize(d)


def ggx_d(n_dot_h, alpha):
    """GGX / Trowbridge-Reitz normal distribution D(h); alpha is the
    squared perceptual roughness."""
    a2 = alpha * alpha
    c = n_dot_h * n_dot_h * (a2 - 1.0) + 1.0
    return a2 / torch.clamp(PI * c * c, min=1e-12)


def ggx_d_vec(normal, h, alpha):
    """D(h) from the vectors, f32-stable at low roughness: sin^2 from the
    cross product (the scalar form's ``(n.h)^2 (a^2 - 1) + 1`` cancels
    when n.h -> 1), c = sin^2 + a^2 cos^2."""
    cr = cross(normal, h)
    sin2 = dot(cr, cr)
    a2 = alpha * alpha
    c = sin2 + a2 * torch.clamp(1.0 - sin2, min=0.0)
    return a2 / torch.clamp(PI * c * c, min=1e-12)


def ggx_g1(n_dot_x, alpha):
    """Smith GGX masking term G1 for one direction (separable Smith:
    G2(v, l) = G1(v) * G1(l)); below-horizon directions give 0."""
    a2 = alpha * alpha
    nx = torch.clamp(n_dot_x, min=0.0)
    return 2.0 * nx / torch.clamp(
        nx + torch.sqrt(a2 + (1.0 - a2) * nx * nx), min=1e-12)


def ggx_vndf_sample_from_uniforms(view, normal, alpha, u1, u2):
    """A GGX half-vector from the distribution of visible normals (Heitz,
    JCGT 2018).  ``view`` points away from the surface, ``normal`` is the
    face-forwarded shading normal, ``alpha`` the squared perceptual
    roughness, ``u1``/``u2`` uniforms in [0, 1).  Returns the half-vector
    in world space; the reflected direction's estimator weight is
    F(h.v) * G1(n.l)."""
    tu, tv = orthonormal_basis(normal)
    vx = dot(view, tu)
    vy = dot(view, tv)
    vz = dot(view, normal)
    # stretch the view vector into the hemisphere configuration
    h = torch.stack([alpha * vx, alpha * vy, vz], -1)
    h = h / torch.sqrt(torch.clamp(dot(h, h), min=1e-20))[..., None]
    # orthonormal frame around the stretched view
    lensq = h[..., 0] * h[..., 0] + h[..., 1] * h[..., 1]
    inv_len = 1.0 / torch.sqrt(torch.clamp(lensq, min=1e-20))
    ex = constant((1.0, 0.0, 0.0), h.device, h.dtype)
    t1 = torch.where((lensq > 1e-16)[..., None],
                     torch.stack([-h[..., 1] * inv_len, h[..., 0] * inv_len,
                                  torch.zeros_like(inv_len)], -1),
                     ex.expand_as(h))
    t2 = cross(h, t1)
    # disk sample warped toward the configuration's visible half
    r = torch.sqrt(torch.clamp(u1, min=0.0))
    phi = 2.0 * PI * u2
    p1 = r * torch.cos(phi)
    p2 = r * torch.sin(phi)
    s = 0.5 * (1.0 + h[..., 2])
    p2 = (1.0 - s) * torch.sqrt(torch.clamp(1.0 - p1 * p1, min=0.0)) + s * p2
    pz = torch.sqrt(torch.clamp(1.0 - p1 * p1 - p2 * p2, min=0.0))
    nh = p1[..., None] * t1 + p2[..., None] * t2 + pz[..., None] * h
    # unstretch back to the ellipsoid
    m = torch.stack([alpha * nh[..., 0], alpha * nh[..., 1],
                     torch.clamp(nh[..., 2], min=0.0)], -1)
    m = m / torch.sqrt(torch.clamp(dot(m, m), min=1e-20))[..., None]
    # local -> world
    return m[..., 0:1] * tu + m[..., 1:2] * tv + m[..., 2:3] * normal
