"""Threaded-BVH traversal, the port of ``tyrant_tpu/ops/traverse.py``.

:class:`BVHDevice` packs the host BVH exactly as the JAX package does.
:func:`closest_hit` and :func:`any_hit` walk the stackless per-octant
threaded links as a batched PyTorch loop: every iteration advances each
live ray by one node, and finished rays leave the batch, so the work per
iteration shrinks with the live count.  This is the plain version of the
CUDA traversal kernel (``ops/kernels/traverse.py``) and the CPU path of
the renderer; it runs on any device.  :func:`traversal_depth_map` counts
each ray's node visits for the CLI's ``bvh-debug`` heatmap.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import EPSILON, VERY_FAR
from ..scene.bvh import (META_AXIS_MASK, META_AXIS_SHIFT, META_COUNT_MASK,
                         META_OFFSET_SHIFT)
from .intersect import moller_trumbore

LEAF_WIDTH = 6  # == BVHConfig.max_prims_per_leaf


@dataclasses.dataclass
class BVHDevice:
    """BVH and leaf-order triangle tables on one device.

    node_packed: [Nn, 8] f32 — lo.xyz, hi.xyz, meta (bit pattern of an
        i32), lane 7 (bit pattern of an i32: second child for interiors,
        leaf row for leaves).
    miss_flat: [8 * Nn] i32 — per-octant escape links, octant-major.
    tri_packed: [T + pad, 12] f32 — v0.xyz, e1.xyz, e2.xyz, pad (leaf order).
    leaf_packed: [L, 9 * LEAF_WIDTH] f32 — per-leaf triangle slots.
    """

    node_packed: torch.Tensor
    miss_flat: torch.Tensor
    tri_packed: torch.Tensor
    leaf_packed: torch.Tensor

    @property
    def n_nodes(self) -> int:
        return self.node_packed.shape[0]

    # the triangles' columns of ``tri_packed`` (leaf order, padding rows
    # included, as the JAX properties return them)
    @property
    def tri_vert(self) -> torch.Tensor:
        return self.tri_packed[:, 0:3]

    @property
    def tri_e1(self) -> torch.Tensor:
        return self.tri_packed[:, 3:6]

    @property
    def tri_e2(self) -> torch.Tensor:
        return self.tri_packed[:, 6:9]

    @classmethod
    def from_host(cls, bvh, tri_vert, tri_e1, tri_e2, device) -> "BVHDevice":
        """bvh: scene.bvh.BVHArrays; tri_*: [T,3] in ORIGINAL
        order (permuted to leaf order and padded here)."""
        nn = bvh.n_nodes
        count = bvh.prim_count
        offset = bvh.prim_offset
        is_leaf = count > 0

        perm = bvh.perm
        t = perm.shape[0]
        tri = np.zeros((t + LEAF_WIDTH - 1, 12), np.float32)
        tri[:t, 0:3] = tri_vert[perm]
        tri[:t, 3:6] = tri_e1[perm]
        tri[:t, 6:9] = tri_e2[perm]

        leaf_ids = np.nonzero(is_leaf)[0]
        tri9 = np.concatenate([tri[:, 0:3], tri[:, 3:6], tri[:, 6:9]], axis=1)
        tri9 = np.vstack([tri9, np.zeros((1, 9), np.float32)])
        slot = offset[leaf_ids][:, None] + np.arange(LEAF_WIDTH)[None]
        slot = np.where(np.arange(LEAF_WIDTH)[None] < count[leaf_ids][:, None],
                        slot, tri9.shape[0] - 1)
        leaf_packed = tri9[slot].reshape(len(leaf_ids), 9 * LEAF_WIDTH) \
            if len(leaf_ids) else np.zeros((1, 9 * LEAF_WIDTH), np.float32)

        leaf_row = np.zeros(nn, np.int32)
        leaf_row[leaf_ids] = np.arange(len(leaf_ids), dtype=np.int32)
        lane7 = np.where(is_leaf, leaf_row, bvh.second_child).astype(np.int32)

        node = np.zeros((nn, 8), np.float32)
        node[:, 0:3] = bvh.lo
        node[:, 3:6] = bvh.hi
        node[:, 6] = bvh.meta.view(np.float32)
        node[:, 7] = lane7.view(np.float32)
        return cls.from_numpy(node, bvh.miss_link.reshape(-1), tri,
                              leaf_packed, device)

    @classmethod
    def from_numpy(cls, node_packed, miss_flat, tri_packed, leaf_packed,
                   device) -> "BVHDevice":
        def t(a, dtype):
            return torch.as_tensor(np.array(a, dtype), device=device)
        return cls(node_packed=t(node_packed, np.float32),
                   miss_flat=t(miss_flat, np.int32),
                   tri_packed=t(tri_packed, np.float32),
                   leaf_packed=t(leaf_packed, np.float32))


def _walk(origin, direction, limit, bvh: BVHDevice, closest: bool, live,
          stats: dict | None = None):
    """Shared closest-hit / any-hit loop over the threaded links.

    closest=True: ``limit`` is t_init; returns (t_best, hit_id).
    closest=False: ``limit`` is the max distance; returns occluded.
    ``stats``: a dict that, when given, receives the work these rays
    needed: "box_tests" (node boxes tested), "tri_tests" (triangles
    tested), "rows" ([Nn] bool, the interior nodes whose box some ray
    hit: the fat rows a traversal kernel must read), "leaves" ([Nn] bool,
    the leaves whose triangles some ray tested) and "tris_read" (the
    triangles of those leaves: each distinct triangle tested, once),
    "visits" ([N] i64,
    the boxes each ray tested; they sum to "box_tests") and "row_visits"
    ([N] i64, the interior boxes each ray hit: the fat rows a depth-first
    kernel reads for it, beside the root's, in the same near-first
    order)."""
    n = origin.shape[0]
    dev = origin.device
    nn = bvh.n_nodes
    meta = bvh.node_packed[:, 6].contiguous().view(torch.int32).to(torch.int64)
    lane7_all = bvh.node_packed[:, 7].contiguous().view(torch.int32) \
        .to(torch.int64)
    lo_all = bvh.node_packed[:, 0:3]
    hi_all = bvh.node_packed[:, 3:6]
    count_all = meta & META_COUNT_MASK
    axis_all = (meta >> META_AXIS_SHIFT) & META_AXIS_MASK
    offset_all = meta >> META_OFFSET_SHIFT
    miss_all = bvh.miss_flat.to(torch.int64)
    slot_idx = torch.arange(LEAF_WIDTH, device=dev)

    t_out = limit.clone()
    id_out = torch.full((n,), -1, dtype=torch.int32, device=dev)
    occ_out = torch.zeros((n,), dtype=torch.bool, device=dev)

    idx = torch.nonzero(live).squeeze(1)
    o, d, lim = origin[idx], direction[idx], limit[idx]
    inv = 1.0 / d
    neg = d < 0.0
    octant = neg[:, 0].long() + 2 * neg[:, 1].long() + 4 * neg[:, 2].long()
    node = torch.zeros_like(idx)
    t_best = lim.clone()
    hit_id = torch.full_like(idx, -1)
    occ = torch.zeros_like(neg[:, 0])
    if stats is not None:
        stats.update(box_tests=0, tri_tests=0,
                     rows=torch.zeros((nn,), dtype=torch.bool, device=dev),
                     leaves=torch.zeros((nn,), dtype=torch.bool, device=dev),
                     visits=torch.zeros((n,), dtype=torch.int64, device=dev),
                     row_visits=torch.zeros((n,), dtype=torch.int64,
                                            device=dev))

    while idx.numel():
        lo, hi = lo_all[node], hi_all[node]
        count, axis = count_all[node], axis_all[node]
        lane7 = lane7_all[node]
        near_b = torch.where(neg, hi, lo)
        far_b = torch.where(neg, lo, hi)
        t0 = ((near_b - o) * inv).amax(-1)
        t1 = ((far_b - o) * inv).amin(-1)
        prune = t_best if closest else lim
        box_hit = (t0 <= t1) & (t0 < prune) & (t1 > 0)
        is_leaf = count > 0
        do_leaf = box_hit & is_leaf

        li = torch.nonzero(do_leaf).squeeze(1)
        if stats is not None:
            stats["box_tests"] += idx.numel()
            stats["tri_tests"] += int(count[li].sum())
            stats["rows"][node[box_hit & ~is_leaf]] = True
            stats["leaves"][node[li]] = True
            stats["visits"][idx] += 1
            stats["row_visits"][idx] += (box_hit & ~is_leaf).long()
        if li.numel():
            tv = bvh.leaf_packed[lane7[li]].view(-1, LEAF_WIDTH, 9)
            t6 = moller_trumbore(o[li, None, :], d[li, None, :],
                                 tv[..., 0:3], tv[..., 3:6], tv[..., 6:9])
            lim_l = (t_best if closest else lim)[li, None]
            ok = (t6 > EPSILON) & ((lim_l - t6) > EPSILON) \
                & (slot_idx[None] < count[li, None])
            if closest:
                t6m = torch.where(ok, t6, torch.full_like(t6, VERY_FAR))
                t_min, j = torch.min(t6m, dim=1)
                upd = t_min < t_best[li]
                t_best[li] = torch.where(upd, t_min, t_best[li])
                hit_id[li] = torch.where(upd, offset_all[node[li]] + j,
                                         hit_id[li])
            else:
                occ[li] = occ[li] | ok.any(1)

        axis_neg = neg.gather(1, axis[:, None])[:, 0]
        near = torch.where(axis_neg, lane7, node + 1)
        miss = miss_all[octant * nn + node]
        node = torch.where(box_hit & ~is_leaf, near, miss)
        if not closest:
            node = torch.where(occ, torch.full_like(node, -1), node)

        done = node < 0
        if bool(done.any()):
            di = idx[done]
            if closest:
                t_out[di] = t_best[done]
                id_out[di] = hit_id[done].to(torch.int32)
            else:
                occ_out[di] = occ[done]
            keep = ~done
            idx, o, d, inv, neg = idx[keep], o[keep], d[keep], inv[keep], neg[keep]
            octant, node, lim = octant[keep], node[keep], lim[keep]
            t_best, hit_id, occ = t_best[keep], hit_id[keep], occ[keep]
    if stats is not None:
        stats["tris_read"] = int(count_all[stats["leaves"]].sum())
    return (t_out, id_out) if closest else occ_out


def hit_normals(tri_packed, hit_id):
    """The unnormalised geometric normal cross(e1, e2) [N, 3] of each
    ray's hit triangle (``hit_id``, leaf order, into ``tri_packed``), zero
    where ``hit_id`` is -1.  Each component is two products and a
    difference, rounded one at a time in the traversal kernels' order, so
    their normals output equals it bit for bit."""
    tri = tri_packed[torch.clamp(hit_id, min=0).long()]
    e1x, e1y, e1z = tri[:, 3], tri[:, 4], tri[:, 5]
    e2x, e2y, e2z = tri[:, 6], tri[:, 7], tri[:, 8]
    nrm = torch.stack([e1y * e2z - e1z * e2y, e1z * e2x - e1x * e2z,
                       e1x * e2y - e1y * e2x], dim=1)
    return torch.where((hit_id >= 0)[:, None], nrm, torch.zeros_like(nrm))


def closest_hit(origin, direction, bvh: BVHDevice, t_init=None,
                stats: dict | None = None, normals: bool = False):
    """Closest hit.  origin/direction [N, 3]; t_init optional [N] initial
    closest distance (the sphere pass).  Returns (t [N], prim_id [N] i32)
    with t == t_init (or VERY_FAR) and prim_id == -1 on a miss, and with
    ``normals`` a third output, the hit triangle's :func:`hit_normals`.
    ``stats``: see :func:`_walk`."""
    n = origin.shape[0]
    if t_init is None:
        t_init = torch.full((n,), VERY_FAR, dtype=torch.float32,
                            device=origin.device)
    live = torch.ones((n,), dtype=torch.bool, device=origin.device)
    t, hit_id = _walk(origin, direction, t_init, bvh, True, live, stats)
    if normals:
        return t, hit_id, hit_normals(bvh.tri_packed, hit_id)
    return t, hit_id


def any_hit(origin, direction, max_dist, bvh: BVHDevice, active=None,
            stats: dict | None = None):
    """Shadow-ray occlusion: any t > eps with (max_dist - t) > eps.
    ``active``: optional [N] bool; inactive rays are never occluded.
    Returns occluded [N] bool.  ``stats``: see :func:`_walk`."""
    n = origin.shape[0]
    live = torch.ones((n,), dtype=torch.bool, device=origin.device) \
        if active is None else active
    return _walk(origin, direction, max_dist, bvh, False, live, stats)


def traversal_depth_map(origin, direction, bvh: BVHDevice):
    """BVH-quality heatmap (the reference's BVH_DEBUG mode): the closest
    hit of each ray and the nodes its walk visited, the root included, one
    a step of the walk as in the JAX package.  Returns (t [N], prim_id [N]
    i32, visits [N] i32)."""
    stats: dict = {}
    t, hit_id = closest_hit(origin, direction, bvh, stats=stats)
    return t, hit_id, stats["visits"].to(torch.int32)
