"""Sampling primitives, the port of ``tyrant_tpu/ops/sampling.py`` for the
functions the main path uses.  Vectors are ``[..., 3]`` float32 tensors."""

from __future__ import annotations

import torch

from ..config import PI

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
    ey = torch.tensor([0.0, 1.0, 0.0], dtype=w.dtype, device=w.device)
    ex = torch.tensor([1.0, 0.0, 0.0], dtype=w.dtype, device=w.device)
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


def cone_sample(direction, extent, seed):
    """Uniform sample inside a cone around ``direction`` (sun NEE).
    Returns (new_seed, sample_direction)."""
    seed, rx = rng.random_float2(seed)
    seed, ry = rng.random_float2(seed)
    d = normalize(direction)
    o1 = normalize(ortho(d))
    o2 = normalize(cross(d, o1))
    phi = rx * 2.0 * PI
    z = 1.0 - ry * extent
    oneminus = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    return seed, (torch.cos(phi) * oneminus)[..., None] * o1 \
        + (torch.sin(phi) * oneminus)[..., None] * o2 \
        + z[..., None] * d


def sphere_surface_sample(center, radius, seed):
    """Uniform point on a sphere surface (area light sampling; y gets
    cos(phi), x/z the sine terms).  Returns (new_seed, point)."""
    seed, u = rng.random_float(seed)
    seed, v = rng.random_float(seed)
    cos_phi = 2.0 * u - 1.0
    sin_phi = torch.sqrt(torch.clamp(1.0 - cos_phi * cos_phi, min=0.0))
    theta = 2.0 * PI * v
    offset = torch.stack([sin_phi * torch.sin(theta), cos_phi,
                          sin_phi * torch.cos(theta)], dim=-1)
    return seed, center + radius * offset


def cosine_hemisphere_sample(normal, seed):
    """Cosine-weighted hemisphere direction around ``normal``.
    Returns (new_seed, direction)."""
    seed, r1u = rng.random_float(seed)
    seed, r2 = rng.random_float(seed)
    r1 = 2.0 * PI * r1u
    r2s = torch.sqrt(r2)
    u, v = orthonormal_basis(normal)
    d = u * (torch.cos(r1) * r2s)[..., None] \
        + v * (torch.sin(r1) * r2s)[..., None] \
        + normal * torch.sqrt(torch.clamp(1.0 - r2, min=0.0))[..., None]
    return seed, normalize(d)


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
