"""Breadth-first closest hit over the fat-row table, the plain version of
the stream kernel (``csrc/stream.cu``, wrapped by
:mod:`tyrant_tpu_torch.ops.kernels.stream`) and its CPU path.  It computes
what ``tyrant_tpu/ops/pallas/stream_kernel.py`` (``_level_kernel`` and
``_stream_impl``) computes:

- the frontier starts as one pair per ray: (ray, row 0, lineage t =
  t_init);
- a pair tests both child boxes of its row against its entry t, then the
  left leaf's triangles in order, then the right leaf's, each accept
  (t > EPSILON and lineage t - t > EPSILON) lowering the lineage t;
- each interior child whose box was hit becomes a pair of the next level
  with the pair's final lineage t;
- a pair whose lineage t fell leaves a hit record (ray, t, last accepted
  id); per ray, t is the least of t_init and its records' t, and the id
  the smallest among the records at that t (-1 without a record).

A pair's lineage t depends only on its ancestors, so the result does not
depend on the order in which pairs are visited: the kernel matches this
version exactly.  The per-ray combine packs (t bits, id) into one integer
and takes its minimum, as the kernel's 64-bit ``atomicMin`` does; t is
never negative where a record exists, so its bits order as its value.

A level whose frontier exceeds the capacity keeps its first ``capacity``
pairs and raises the overflow flag.  The levels are bounded by the tree's
depth; there is no level cut.
"""

from __future__ import annotations

import torch

from ..config import EPSILON, VERY_FAR
from .intersect import moller_trumbore
from .kernels.traverse import _L_TAG, _L_TRI, _R_REF, _R_TRI, LEAF_WIDTH

NO_HIT = 0x7FFFFFFF  # id half of a ray's packed best before any record
CHUNK = 1 << 20      # pairs whose rows are gathered at once


def capacity(n: int, cap_mult: int) -> int:
    """Pairs a frontier level holds for ``n`` rays: ``cap_mult`` times the
    ray count padded to 128, in 128-pair tiles rounded up to 8 tiles, as
    ``_stream_impl`` sizes its queues."""
    npad = -(-n // 128) * 128
    tiles = -(-cap_mult * npad // 128)
    return -(-tiles // 8) * 8 * 128


def pack(t, ids):
    """(t bits << 32) | id as int64: ordered by t, then by id."""
    return (t.view(torch.int32).to(torch.int64) << 32) | ids.to(torch.int64)


def unpack(best):
    """(t, id) of packed bests; the NO_HIT id becomes -1."""
    t = (best >> 32).to(torch.int32).view(torch.float32)
    ids = (best & 0xFFFFFFFF).to(torch.int32)
    return t, torch.where(ids == NO_HIT, torch.full_like(ids, -1), ids)


def _slab(box, o, inv, neg, t):
    near = torch.where(neg, box[:, 3:6], box[:, 0:3])
    far = torch.where(neg, box[:, 0:3], box[:, 3:6])
    tmin = ((near - o) * inv).amax(-1)  # amax / amin propagate NaN
    tmax = ((far - o) * inv).amin(-1)
    return (tmin <= tmax) & (tmin < t) & (tmax > 0)


def _visit(rows, origin, direction, ray, row, t_entry, stats):
    """One chunk of a level: returns (lineage t, last accepted id, left
    and right child masks with their rows)."""
    r = rows[row]
    o, d = origin[ray], direction[ray]
    inv, neg = 1.0 / d, d < 0.0
    box_l = _slab(r[:, 0:6], o, inv, neg, t_entry)
    box_r = _slab(r[:, 6:12], o, inv, neg, t_entry)
    tags = r[:, _L_TAG:_R_REF + 1].to(torch.int64)
    tag_l, tag_r, ref_l, ref_r = tags.unbind(1)
    tl = t_entry.clone()
    hit = torch.full_like(ray, NO_HIT)
    for box, tag, ref, base in ((box_l, tag_l, ref_l, _L_TRI),
                                (box_r, tag_r, ref_r, _R_TRI)):
        li = torch.nonzero(box & (tag > 0)).squeeze(1)
        if stats is not None:
            stats["tri_tests"] += int(tag[li].sum())
        if not li.numel():
            continue
        tv = r[li, base:base + 9 * LEAF_WIDTH].view(-1, LEAF_WIDTH, 9)
        t6 = moller_trumbore(o[li, None, :], d[li, None, :], tv[..., 0:3],
                             tv[..., 3:6], tv[..., 6:9])
        t_s, h_s, tag_s, ref_s = tl[li], hit[li], tag[li], ref[li]
        for j in range(LEAF_WIDTH):  # in order: each accept lowers t_s
            t = t6[:, j]
            ok = (j < tag_s) & (t > EPSILON) & ((t_s - t) > EPSILON)
            t_s = torch.where(ok, t, t_s)
            h_s = torch.where(ok, ref_s + j, h_s)
        tl[li], hit[li] = t_s, h_s
    return (tl, hit, box_l & (tag_l < 0), ref_l, box_r & (tag_r < 0), ref_r)


def closest_hit_stream(origin, direction, rows, max_levels: int,
                       t_init=None, cap_mult: int = 3,
                       stats: dict | None = None, chunk: int = CHUNK):
    """Breadth-first closest hit.  origin/direction [N, 3] f32, rows the
    fat-row table [R, 128] f32, t_init optional [N] f32 (default
    VERY_FAR).  Returns (t [N] f32, id [N] i32, overflow flag, a 0-dim
    i32 tensor).  ``max_levels``: the table's depth; a frontier that
    outlives it raises.  ``stats``: a dict that, when given, receives
    "pairs" (the pairs each level asked for, before any capacity cut),
    "levels", "box_tests" (two a pair) and "tri_tests"."""
    n = origin.shape[0]
    dev = origin.device
    if t_init is None:
        t_init = torch.full((n,), VERY_FAR, dtype=torch.float32, device=dev)
    cap = capacity(n, cap_mult)
    best = pack(t_init, torch.full((n,), NO_HIT, dtype=torch.int32,
                                   device=dev))
    ray = torch.arange(n, device=dev)
    row = torch.zeros_like(ray)
    tl = t_init.clone()
    ovf = False
    if stats is not None:
        stats.update(pairs=[], levels=0, box_tests=0, tri_tests=0)
    level = 0
    while ray.numel():
        if level >= max_levels:
            raise RuntimeError(f"the frontier outlived the table's depth "
                               f"({max_levels} levels)")
        level += 1
        if stats is not None:
            stats["levels"] = level
            stats["box_tests"] += 2 * ray.numel()
        kids = []
        for s in range(0, ray.numel(), chunk):
            c_ray, c_row, c_t = ray[s:s + chunk], row[s:s + chunk], tl[s:s + chunk]
            t_out, hit, go_l, ref_l, go_r, ref_r = _visit(
                rows, origin, direction, c_ray, c_row, c_t, stats)
            imp = (c_t - t_out) > 0.0
            best.scatter_reduce_(0, c_ray[imp], pack(t_out[imp], hit[imp]),
                                 "amin")
            kids += [(c_ray[go_l], ref_l[go_l], t_out[go_l]),
                     (c_ray[go_r], ref_r[go_r], t_out[go_r])]
        ray, row, tl = (torch.cat(k) for k in zip(*kids))
        if stats is not None and ray.numel():
            stats["pairs"].append(ray.numel())
        if ray.numel() > cap:
            ovf = True
            ray, row, tl = ray[:cap], row[:cap], tl[:cap]
    if stats is not None:
        stats["pairs"].insert(0, n)
    t, ids = unpack(best)
    return t, ids, torch.tensor(int(ovf), dtype=torch.int32, device=dev)
