"""Fat-row BVH tables and the two CUDA traversal kernels, the port of
``tyrant_tpu/ops/pallas/traverse_kernel.py``: ``csrc/traverse.cu`` (one
ray per lane, any-hit queues compacted to their live slots first; the
counterpart of the mono generation) and ``csrc/traverse_wave.cu`` (one
32-ray packet per warp with one warp-uniform stack, the counterpart of
the wave generation, ``wave=True``).

:class:`PacketTables` builds the fat-row table exactly as the JAX package
does: one 128-float row per interior node, holding both child boxes, tags,
refs, the split axis and two 6-triangle leaf payloads:

  lanes  0-5   left child AABB (lo.xyz, hi.xyz)
  lanes  6-11  right child AABB
  lane   12    left tag:  >0 leaf prim count, <0 interior, 0 empty
  lane   13    right tag
  lane   14    left ref:  row index (interior) / global prim offset (leaf)
  lane   15    right ref
  lane   16    split axis
  lanes  17..  left leaf payload, then right leaf payload (6 x v0,e1,e2)

Integers are stored as exact f32 values, so they must stay below 2^24.
``tables.rows`` is the table of the plain stream traversal and of interop,
and stays on the host.  The kernels (the two depth-first ones and the
stream kernel) read a second table made from it once
(:func:`build_kernel_tables`), laid out for 16-byte vector loads, on the
BVH's device:

  ``nodes`` [R, 16] i32, 64 bytes a row and 64-byte aligned (four loads):
    words 0-11   both child AABBs, the f32 bit patterns of lanes 0-11
    word  12     left tag (bits 0-7, signed) | right tag (bits 8-15,
                 signed) | split axis (bits 16-17)
    words 13-14  left ref, right ref as integers
    word  15     0
  ``tris`` [T, 12] f32, 48 bytes a triangle (three loads): v0, e1, e2 and
    three zeros, at its leaf-order prim offset, so a leaf child's ``tag``
    triangles are the consecutive records from its ``ref``.

Triangles go by prim offset, not by row: a row keeps 12 slots of which the
terrain fills about a third, so by row the table would be 145 MB for 1M
triangles and by offset it is 50 MB, with the leaves of one subtree side by
side; the node part (16 MB for 252,562 rows) then fits the H100's 50 MB L2
on its own.

:func:`closest_hit_packets` and :func:`any_hit_packets` keep the contracts
of their JAX namesakes.  On CUDA tensors they launch the kernel of the
generation ``wave`` names; on CPU tensors they run the plain version of
both, the threaded-link walk of :mod:`tyrant_tpu_torch.ops.traverse`.
All three find the same closest hit up to epsilon ties (hits whose
distances differ by less than EPSILON, where the accept rule depends on
visiting order) and the same any-hit flags.
"""

from __future__ import annotations

import numpy as np
import torch

from ...config import VERY_FAR
from ...scene.bvh import META_AXIS_SHIFT, META_COUNT_MASK, META_OFFSET_SHIFT
from .. import traverse as plain
from . import build

STACK_DEPTH = 128  # row stack of a ray (traverse.cu) or packet (traverse_wave.cu)
ROW_WIDTH = 128
LEAF_WIDTH = 6
_L_TAG, _R_TAG, _L_REF, _R_REF, _AXIS = 12, 13, 14, 15, 16
_L_TRI = 17
_R_TRI = _L_TRI + 9 * LEAF_WIDTH

# kernel launches since the last reset, per generation (closest and any
# hit alike): ``launches`` for traverse.cu, ``launches_wave`` for
# traverse_wave.cu; of those, the launches with the normals output in
# ``launches_normals`` and ``launches_wave_normals``; plain-version calls
# are not counted
launches = 0
launches_wave = 0
launches_normals = 0
launches_wave_normals = 0


def build_rows(bvh: plain.BVHDevice) -> np.ndarray:
    """The fat-row table [I, 128] f32 of a BVH."""
    node = bvh.node_packed.cpu().numpy()
    leaf_packed = bvh.leaf_packed.cpu().numpy()
    meta = node[:, 6].copy().view(np.int32)
    lane7 = node[:, 7].copy().view(np.int32)  # second child / leaf row
    count = meta & META_COUNT_MASK
    axis = (meta >> META_AXIS_SHIFT) & 3
    offset = meta >> META_OFFSET_SHIFT
    is_leaf = count > 0
    nn = node.shape[0]

    if nn == 1:
        # single-node tree (or the spheres-only stub): pseudo-root with the
        # lone leaf on the left and an empty right child
        rows = np.zeros((1, ROW_WIDTH), np.float32)
        rows[0, 0:6] = node[0, 0:6]
        rows[0, 6:9] = 1e10   # inverted box: never hit
        rows[0, 9:12] = -1e10
        rows[0, _L_TAG] = float(count[0])
        rows[0, _L_REF] = float(offset[0])
        if is_leaf[0]:
            rows[0, _L_TRI:_L_TRI + 9 * LEAF_WIDTH] = leaf_packed[lane7[0]]
        return rows

    interior = np.nonzero(~is_leaf)[0]
    n_rows = len(interior)
    # BFS row numbering, siblings adjacent, root at row 0 (the JAX
    # package's order, so the two tables are equal bit for bit)
    levels = []
    frontier = np.asarray([0] if not is_leaf[0] else [], np.int64)
    while frontier.size:
        levels.append(frontier)
        kids = np.stack([frontier + 1, lane7[frontier]], axis=1).reshape(-1)
        frontier = kids[~is_leaf[kids]]
    order_seq = np.concatenate(levels) if levels else np.zeros((0,), np.int64)
    row_of = np.full(nn, -1, np.int64)
    row_of[order_seq] = np.arange(n_rows)

    rr = row_of[interior]
    rows = np.zeros((n_rows, ROW_WIDTH), np.float32)
    rows[rr, _AXIS] = axis[interior].astype(np.float32)
    for side, child, tag_c, ref_c, tri_c in (
            ("L", interior + 1, _L_TAG, _L_REF, _L_TRI),
            ("R", lane7[interior], _R_TAG, _R_REF, _R_TRI)):
        base = 0 if side == "L" else 6
        rows[rr, base:base + 6] = node[child, 0:6]
        child_leaf = is_leaf[child]
        rows[rr, tag_c] = np.where(child_leaf, count[child],
                                   -1).astype(np.float32)
        rows[rr, ref_c] = np.where(child_leaf, offset[child],
                                   row_of[child]).astype(np.float32)
        lp = np.where(child_leaf, lane7[child], 0)
        payload = leaf_packed[lp]
        payload[~child_leaf] = 0.0
        rows[rr, tri_c:tri_c + 9 * LEAF_WIDTH] = payload
    return rows


NODE_WORDS = 16  # i32 words of a kernel-side node record (64 bytes)
TRI_WORDS = 12   # f32 words of a kernel-side triangle record (48 bytes)
NODE_ALIGN = 64  # bytes: a record never straddles two 64-byte lines


def build_kernel_tables(rows: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(nodes [R, 16] i32, tris [T, 12] f32) of a fat-row table: the layout
    the depth-first kernels read (see the module's docstring).  T is the
    end of the last leaf's prim range, at least 1."""
    n_rows = rows.shape[0]
    tags = rows[:, [_L_TAG, _R_TAG]].astype(np.int32)
    refs = rows[:, [_L_REF, _R_REF]].astype(np.int32)
    axis = rows[:, _AXIS].astype(np.int32)
    nodes = np.zeros((n_rows, NODE_WORDS), np.int32)
    nodes[:, 0:12] = np.ascontiguousarray(rows[:, 0:12]).view(np.int32)
    nodes[:, 12] = (tags[:, 0] & 0xff) | ((tags[:, 1] & 0xff) << 8) \
        | (axis << 16)
    nodes[:, 13:15] = refs
    ends = np.where(tags > 0, refs + tags, 0)
    tris = np.zeros((max(int(ends.max(initial=0)), 1), TRI_WORDS), np.float32)
    for side, tri_c in ((0, _L_TRI), (1, _R_TRI)):
        for j in range(LEAF_WIDTH):
            has = tags[:, side] > j
            tris[refs[has, side] + j, 0:9] = \
                rows[has, tri_c + 9 * j:tri_c + 9 * j + 9]
    return nodes, tris


def _aligned(a: np.ndarray, device) -> torch.Tensor:
    """``a`` in a tensor from torch's allocator (64-byte aligned on the
    CPU, 512 on CUDA; numpy's own memory is only 16-byte aligned)."""
    src = torch.from_numpy(a)
    out = torch.empty_like(src, device=device).copy_(src)
    if out.data_ptr() % NODE_ALIGN:
        raise RuntimeError(f"kernel table at {out.data_ptr():#x} is not "
                           f"{NODE_ALIGN}-byte aligned")
    return out


def _interior_depth(rows: np.ndarray) -> int:
    """Levels of interior rows below and including the root (row 0)."""
    depth, frontier = 0, np.asarray([0], np.int64)
    while frontier.size:
        depth += 1
        r = rows[frontier]
        kids = [r[r[:, tag] < 0, ref] for tag, ref in ((_L_TAG, _L_REF),
                                                      (_R_TAG, _R_REF))]
        frontier = np.concatenate(kids).astype(np.int64)
    return depth


class PacketTables:
    """Traversal tables of one scene's BVH.

    ``rows``: the fat-row table, on the host whatever the BVH's device (no
    kernel reads it).  ``nodes`` and ``tris``: the kernel-side table
    (:func:`build_kernel_tables`), on the BVH's device.  ``supported`` is
    False when the scene exceeds the exact-f32 integer range (2^24 rows or
    primitive offsets) or the tree is deeper than the kernel's stack; the
    renderer then refuses the scene.  ``bvh`` is kept for the plain
    depth-first version, which walks the threaded links.
    """

    def __init__(self, bvh: plain.BVHDevice, rows: np.ndarray | None = None):
        """``rows``: a fat-row table built elsewhere (the JAX package's,
        through interop); None builds it from ``bvh``."""
        rows = build_rows(bvh) if rows is None else np.array(rows, np.float32)
        self.bvh = bvh
        dev = bvh.node_packed.device
        self.rows = torch.from_numpy(rows)
        self.nodes, self.tris = (_aligned(a, dev)
                                 for a in build_kernel_tables(rows))
        self.max_depth = _interior_depth(rows) + 1  # + the leaf level
        leaf_refs = np.concatenate([rows[rows[:, _L_TAG] > 0, _L_REF],
                                    rows[rows[:, _R_TAG] > 0, _R_REF]])
        max_ref = int(leaf_refs.max()) + LEAF_WIDTH if leaf_refs.size else 0
        self.supported = (max(rows.shape[0], max_ref) < 2 ** 24
                          and self.max_depth + 2 <= STACK_DEPTH)


def _check_rays(origin, direction, t, tables: PacketTables):
    n = origin.shape[0]
    dev = tables.nodes.device
    for name, x, shape in (("origin", origin, (n, 3)),
                           ("direction", direction, (n, 3)),
                           ("t_init/max_dist", t, (n,))):
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, the tables on {dev}")
        if x.dtype != torch.float32 or tuple(x.shape) != shape \
                or not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32 of shape "
                             f"{shape}, got {x.dtype} {tuple(x.shape)}")
    if not tables.supported:
        raise ValueError("fat-row table unsupported (over 2^24 rows or "
                         "prims, or deeper than the traversal stack)")


def check_kernel_tables(tables: PacketTables) -> None:
    """Raise unless the kernel-side table is what the kernels' vector loads
    take: contiguous, the nodes 64-byte and the triangles 16-byte
    aligned."""
    nodes, tris = tables.nodes, tables.tris
    if not (nodes.is_contiguous() and tris.is_contiguous()) \
            or nodes.data_ptr() % NODE_ALIGN or tris.data_ptr() % 16:
        raise ValueError("the kernel-side table must be contiguous, its "
                         "nodes 64-byte and its triangles 16-byte aligned")


def _launch(origin, direction, t, tables: PacketTables, closest: bool,
            wave: bool, normals: bool = False):
    global launches, launches_wave, launches_normals, launches_wave_normals
    nodes, tris = tables.nodes, tables.tris
    check_kernel_tables(tables)
    lib = build.load()
    fn = lib.tyrant_traverse_wave if wave else lib.tyrant_traverse
    n = origin.shape[0]
    t_out = torch.empty_like(t)
    hit = torch.empty((n,), dtype=torch.int32, device=origin.device)
    nrm = torch.empty((n, 3), dtype=torch.float32, device=origin.device) \
        if normals else None
    stream = torch.cuda.current_stream(origin.device).cuda_stream
    err = fn(nodes.data_ptr(), nodes.shape[0], tris.data_ptr(),
             origin.data_ptr(),
             direction.data_ptr(), t.data_ptr(), t_out.data_ptr(),
             hit.data_ptr(), None if nrm is None else nrm.data_ptr(), n,
             int(closest), stream)
    build.check(lib, err, f"{fn.__name__} launch")
    if wave:
        launches_wave += 1
        launches_wave_normals += normals
    else:
        launches += 1
        launches_normals += normals
    return (t_out, hit, nrm) if normals else (t_out, hit)


def closest_hit_packets(origin, direction, tables: PacketTables,
                        t_init=None, wave: bool = False,
                        normals: bool = False):
    """Closest hit.  origin/direction [N, 3] f32; t_init optional [N] f32.
    Returns (t [N], leaf-order prim id [N] i32), with t == t_init and id
    -1 where nothing beats t_init; with ``normals`` also the hit
    triangle's unnormalised cross(e1, e2) [N, 3] f32, zero where the id is
    -1 (:func:`tyrant_tpu_torch.ops.traverse.hit_normals`).  ``wave``: the
    warp-packet kernel instead of the one-ray-per-thread kernel (CUDA
    tensors only)."""
    n = origin.shape[0]
    if t_init is None:
        t_init = torch.full((n,), VERY_FAR, dtype=torch.float32,
                            device=origin.device)
    _check_rays(origin, direction, t_init, tables)
    if origin.device.type == "cpu":
        return plain.closest_hit(origin, direction, tables.bvh, t_init,
                                 normals=normals)
    if origin.device.type != "cuda":
        raise ValueError(f"no traversal for device {origin.device}")
    return _launch(origin, direction, t_init, tables, closest=True,
                   wave=wave, normals=normals)


def any_hit_packets(origin, direction, max_dist, tables: PacketTables,
                    active=None, wave: bool = False):
    """Occlusion before max_dist.  ``active``: optional [N] bool; inactive
    rays are never occluded.  Returns occluded [N] bool.  ``wave`` as in
    :func:`closest_hit_packets`."""
    if active is not None:
        max_dist = torch.where(active, max_dist, torch.zeros_like(max_dist))
    _check_rays(origin, direction, max_dist, tables)
    if origin.device.type == "cpu":
        return plain.any_hit(origin, direction, max_dist, tables.bvh,
                             active=max_dist > 0.0)
    if origin.device.type != "cuda":
        raise ValueError(f"no traversal for device {origin.device}")
    _, occ = _launch(origin, direction, max_dist, tables, closest=False,
                     wave=wave)
    return occ > 0
