"""Intersection primitives, the port of ``tyrant_tpu/ops/intersect.py``:
Möller-Trumbore with back-face culling and the analytic sphere."""

from __future__ import annotations

import torch

from ..config import EPSILON, VERY_FAR


def moller_trumbore(origin, direction, vert, e1, e2):
    """Möller-Trumbore, rejecting det < 1e-7 (back faces and parallel
    rays).  Returns t on a hit, 0 on a miss.  Written component by
    component in the order the CUDA traversal kernel uses, so the two
    round alike."""
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


def intersect_spheres(origin, direction, centers, radii):
    """Closest hit against a small sphere list; the lowest index wins
    ties.  Returns (t [N], idx [N]) with VERY_FAR / -1 on a miss."""
    t_all = ray_sphere(origin[:, None, :], direction[:, None, :],
                       centers[None, :, :], radii[None, :])  # [N, S]
    t_all = torch.where(t_all > 0.0, t_all, torch.full_like(t_all, VERY_FAR))
    t, idx = torch.min(t_all, dim=1)
    idx = torch.where(t < VERY_FAR, idx, torch.full_like(idx, -1))
    return t, idx.to(torch.int32)
