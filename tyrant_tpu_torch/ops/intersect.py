"""Intersection primitives, the port of ``tyrant_tpu/ops/intersect.py``:
the slab test, Möller-Trumbore with back-face culling, the analytic sphere
(closest and any hit: the plain versions of ``ops/kernels/spheres.py``)
and the brute-force closest hit over every triangle (the no-BVH oracle
that the tests hold the traversal against)."""

from __future__ import annotations

import torch

from ..config import EPSILON, VERY_FAR

BRUTE_CHUNK_PAIRS = 1 << 20  # ray-triangle pairs a chunk of the oracle


def ray_aabb(origin, inv_dir, dir_is_neg, lo, hi, t_max):
    """Slab test.  origin/inv_dir [..., 3]; dir_is_neg [..., 3] bool;
    lo/hi [..., 3] (one box a ray); t_max [...] the current closest hit,
    for early rejection.  Returns bool [...]."""
    near = torch.where(dir_is_neg, hi, lo)
    far = torch.where(dir_is_neg, lo, hi)
    t0 = (near - origin) * inv_dir
    t1 = (far - origin) * inv_dir
    t_min_v = t0.amax(dim=-1)
    t_max_v = t1.amin(dim=-1)
    return (t_min_v <= t_max_v) & (t_min_v < t_max) & (t_max_v > 0)


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


def ray_spheres(origin, direction, centers, radii):
    """:func:`ray_sphere` of every ray [N] against every sphere [S]: t
    [N, S], 0 on a miss."""
    return ray_sphere(origin[:, None, :], direction[:, None, :],
                      centers[None, :, :], radii[None, :])


def intersect_spheres(origin, direction, centers, radii):
    """Closest hit against a small sphere list; the lowest index wins
    ties.  Returns (t [N], idx [N]) with VERY_FAR / -1 on a miss."""
    t_all = ray_spheres(origin, direction, centers, radii)
    t_all = torch.where(t_all > 0.0, t_all, torch.full_like(t_all, VERY_FAR))
    t, idx = torch.min(t_all, dim=1)
    idx = torch.where(t < VERY_FAR, idx, torch.full_like(idx, -1))
    return t, idx.to(torch.int32)


def any_hit_spheres(origin, direction, centers, radii, max_dist):
    """Whether a sphere occludes each ray before ``max_dist`` [N]: bool
    [N], True where some sphere lies at 0 < t with t + EPSILON <
    max_dist (never where max_dist <= 0)."""
    t_all = ray_spheres(origin, direction, centers, radii)
    return ((t_all > 0.0) & ((t_all + EPSILON) < max_dist[:, None])).any(1)


def intersect_triangles_brute(origin, direction, vert, e1, e2, t_max=None):
    """Closest hit over every triangle, with no BVH: the oracle of the
    traversal tests; no render path calls it.  origin/direction [N, 3];
    vert/e1/e2 [T, 3]; t_max optional [N].  Returns (t [N], tri_idx [N]
    i32), VERY_FAR / -1 on a miss.  Accepts t > EPSILON, and of equal
    distances the lowest index, as the leaf test does.  Rays go in chunks
    of at most ``BRUTE_CHUNK_PAIRS`` ray-triangle pairs, so memory stays
    at a few [chunk, T] tensors."""
    n, n_tri = origin.shape[0], vert.shape[0]
    t = torch.full((n,), VERY_FAR, dtype=torch.float32, device=origin.device)
    idx = torch.full((n,), -1, dtype=torch.int32, device=origin.device)
    if n_tri == 0:
        return t, idx
    step = max(1, BRUTE_CHUNK_PAIRS // n_tri)
    for s in range(0, n, step):
        t_all = moller_trumbore(origin[s:s + step, None, :],
                                direction[s:s + step, None, :],
                                vert[None], e1[None], e2[None])  # [n, T]
        t_all = torch.where(t_all > EPSILON, t_all,
                            torch.full_like(t_all, VERY_FAR))
        i = torch.argmin(t_all, dim=1)
        t[s:s + step] = torch.gather(t_all, 1, i[:, None])[:, 0]
        idx[s:s + step] = i.to(torch.int32)
    miss = t >= (VERY_FAR if t_max is None else t_max)
    return (torch.where(miss, torch.full_like(t, VERY_FAR), t),
            torch.where(miss, torch.full_like(idx, -1), idx))
