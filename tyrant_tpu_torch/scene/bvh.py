"""Binned-SAH BVH builder (numpy) and its threaded links.

The port's own copy of the JAX package's builder, equal to it bit for bit
(tests/test_torch_scene.py).  Nodes are laid out depth first with the
left child at ``current + 1`` and the right child in ``second_child``;
14-bucket binned SAH on the largest centroid-extent axis; leaves of at
most ``BVHConfig.max_prims_per_leaf`` primitives (ranges with degenerate
centroid bounds are split at the median until they fit); triangles are
reordered so each leaf's primitives are contiguous (``perm``).

``thread_links`` adds, per direction octant, each node's escape link:
the node visited after its subtree in near-child-first order.  The plain
traversal (``ops/traverse.py``) walks those links without a stack.
``tyrant_tpu_torch.native`` builds the same tree in C++.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..config import BVHConfig

# meta packing: bits 0..2 = prim_count (0 => interior), bits 3..4 = split
# axis, bits 5.. = prim_offset (leaf)
META_COUNT_BITS = 3
META_AXIS_BITS = 2
META_COUNT_MASK = (1 << META_COUNT_BITS) - 1
META_AXIS_SHIFT = META_COUNT_BITS
META_AXIS_MASK = (1 << META_AXIS_BITS) - 1
META_OFFSET_SHIFT = META_COUNT_BITS + META_AXIS_BITS


@dataclasses.dataclass
class BVHArrays:
    """Flat SoA BVH, host-side (numpy)."""

    lo: np.ndarray            # [Nn, 3] f32 node bounds min
    hi: np.ndarray            # [Nn, 3] f32 node bounds max
    meta: np.ndarray          # [Nn] i32 packed (see module header)
    second_child: np.ndarray  # [Nn] i32 (-1 for leaves)
    hit_link: np.ndarray      # [2, Nn] i32 near child by dir sign on node axis
    miss_link: np.ndarray     # [8, Nn] i32 escape pointer per direction octant
    perm: np.ndarray          # [T] i32 triangle reorder (leaf-contiguous)
    n_nodes: int

    @property
    def prim_count(self):
        return self.meta & META_COUNT_MASK

    @property
    def split_axis(self):
        return (self.meta >> META_AXIS_SHIFT) & META_AXIS_MASK

    @property
    def prim_offset(self):
        return self.meta >> META_OFFSET_SHIFT


def pack_meta(offset, count, axis):
    return ((offset.astype(np.int64) << META_OFFSET_SHIFT)
            | ((axis.astype(np.int64) & META_AXIS_MASK) << META_AXIS_SHIFT)
            | (count.astype(np.int64) & META_COUNT_MASK)).astype(np.int32)


def _surface_area(lo, hi):
    d = np.maximum(hi - lo, 0.0)
    return 2.0 * (d[..., 0] * d[..., 1] + d[..., 0] * d[..., 2]
                  + d[..., 1] * d[..., 2])


def build_bvh(tri_lo: np.ndarray, tri_hi: np.ndarray,
              cfg: BVHConfig = BVHConfig(),
              method: str = "sah") -> BVHArrays:
    """Build the BVH from per-triangle AABBs.

    tri_lo/tri_hi: [T, 3] float32.  method: "sah" or "equal_counts".
    Returns BVHArrays with nodes in depth-first order (left = current+1).
    """
    tri_lo = np.asarray(tri_lo, np.float32)
    tri_hi = np.asarray(tri_hi, np.float32)
    n_prims = tri_lo.shape[0]
    assert n_prims > 0, "empty scene"

    centroid = (tri_lo + tri_hi) * 0.5
    max_nodes = 2 * n_prims

    lo = np.empty((max_nodes, 3), np.float32)
    hi = np.empty((max_nodes, 3), np.float32)
    offset_arr = np.zeros(max_nodes, np.int64)
    count_arr = np.zeros(max_nodes, np.int64)
    axis_arr = np.zeros(max_nodes, np.int64)
    second_child = np.full(max_nodes, -1, np.int32)

    # primitive index working array; leaves append to `order`
    prim_idx = np.arange(n_prims, dtype=np.int64)
    order = np.empty(n_prims, np.int64)
    order_size = 0
    n_nodes = 0

    n_buckets = cfg.bucket_number
    max_leaf = cfg.max_prims_per_leaf
    trav_cost = cfg.traversal_cost
    isect_cost = cfg.intersection_cost

    # explicit stack of (start, end, parent, is_second_child); the parent
    # link sets second_child once the left subtree is emitted
    stack = [(0, n_prims, -1, False)]
    while stack:
        start, end, parent, is_second = stack.pop()
        node = n_nodes
        n_nodes += 1
        if is_second and parent >= 0:
            second_child[parent] = node

        # copy: prim_idx[start:end] is written through below while `ids` is read
        ids = prim_idx[start:end].copy()
        node_lo = tri_lo[ids].min(axis=0)
        node_hi = tri_hi[ids].max(axis=0)
        lo[node] = node_lo
        hi[node] = node_hi
        np_range = end - start

        def make_leaf():
            nonlocal order_size
            offset_arr[node] = order_size
            count_arr[node] = np_range
            order[order_size:order_size + np_range] = prim_idx[start:end]
            order_size += np_range

        if np_range == 1:
            make_leaf()
            continue

        cent = centroid[ids]
        c_lo = cent.min(axis=0)
        c_hi = cent.max(axis=0)
        ext = c_hi - c_lo
        # largest extent, ties broken x > y > z
        dim = int(np.argmax(ext))
        if not (ext[0] > ext[1] and ext[0] > ext[2]):
            dim = 1 if ext[1] > ext[2] else 2

        if c_hi[dim] == c_lo[dim]:
            # degenerate centroid bounds: split at the median until the
            # range fits in a leaf
            if np_range <= max_leaf:
                make_leaf()
                continue
            mid = (start + end) // 2
            stack.append((mid, end, node, True))
            stack.append((start, mid, node, False))
            axis_arr[node] = dim
            continue

        if method == "equal_counts":
            mid = (start + end) // 2
            sel = np.argpartition(cent[:, dim], mid - start)
            prim_idx[start:end] = ids[sel]
            axis_arr[node] = dim
            stack.append((mid, end, node, True))
            stack.append((start, mid, node, False))
            continue

        # --- binned SAH ---
        scaled = (cent[:, dim] - c_lo[dim]) / (c_hi[dim] - c_lo[dim])
        b = np.minimum((n_buckets * scaled).astype(np.int64), n_buckets - 1)

        counts = np.bincount(b, minlength=n_buckets)
        blo = np.full((n_buckets, 3), np.inf, np.float32)
        bhi = np.full((n_buckets, 3), -np.inf, np.float32)
        np.minimum.at(blo, b, tri_lo[ids])
        np.maximum.at(bhi, b, tri_hi[ids])

        # prefix/suffix unions for split costs
        lo_pre = np.minimum.accumulate(blo, axis=0)
        hi_pre = np.maximum.accumulate(bhi, axis=0)
        lo_suf = np.minimum.accumulate(blo[::-1], axis=0)[::-1]
        hi_suf = np.maximum.accumulate(bhi[::-1], axis=0)[::-1]
        cnt_pre = np.cumsum(counts)
        cnt_suf = np.cumsum(counts[::-1])[::-1]

        area = _surface_area(node_lo, node_hi)
        sa_pre = np.where(cnt_pre[:-1] > 0, _surface_area(lo_pre[:-1], hi_pre[:-1]), 0.0)
        sa_suf = np.where(cnt_suf[1:] > 0, _surface_area(lo_suf[1:], hi_suf[1:]), 0.0)
        cost = trav_cost + (cnt_pre[:-1] * sa_pre + cnt_suf[1:] * sa_suf) / area
        best = int(np.argmin(cost))
        min_cost = cost[best]

        leaf_cost = isect_cost * np_range
        if np_range > max_leaf or min_cost < leaf_cost:
            left_mask = b <= best
            mid = start + int(left_mask.sum())
            # stable partition
            prim_idx[start:mid] = ids[left_mask]
            prim_idx[mid:end] = ids[~left_mask]
            axis_arr[node] = dim
            stack.append((mid, end, node, True))
            stack.append((start, mid, node, False))
        else:
            make_leaf()

    lo = lo[:n_nodes]
    hi = hi[:n_nodes]
    meta = pack_meta(offset_arr[:n_nodes], count_arr[:n_nodes], axis_arr[:n_nodes])
    second_child = second_child[:n_nodes]

    hit_link, miss_link = thread_links(meta, second_child)
    return BVHArrays(lo=lo, hi=hi, meta=meta, second_child=second_child,
                     hit_link=hit_link, miss_link=miss_link,
                     perm=order.astype(np.int32), n_nodes=n_nodes)


def thread_links(meta: np.ndarray, second_child: np.ndarray):
    """Stackless hit/miss links.

    hit_link[s, n] for interior n = near child when the ray direction is
    negative (s=1) / non-negative (s=0) along n's split axis.  For leaves
    it is -1 (never read).  miss_link[o, n] = node visited after n's
    subtree under direction octant o (bit i of o = direction negative
    along axis i); -1 terminates.
    """
    n_nodes = meta.shape[0]
    count = meta & META_COUNT_MASK
    axis = (meta >> META_AXIS_SHIFT) & META_AXIS_MASK
    is_leaf = count > 0
    first_child = np.arange(n_nodes, dtype=np.int32) + 1

    hit_link = np.empty((2, n_nodes), np.int32)
    hit_link[0] = np.where(is_leaf, -1, first_child)
    hit_link[1] = np.where(is_leaf, -1, second_child)

    miss_link = np.empty((8, n_nodes), np.int32)
    for octant in range(8):
        neg = np.array([(octant >> a) & 1 for a in range(3)])
        node_neg = neg[axis]  # per-node: is dir negative along split axis
        near = np.where(node_neg == 1, second_child, first_child)
        far = np.where(node_neg == 1, first_child, second_child)
        ml = np.full(n_nodes, -1, np.int32)
        stack = [(0, -1)]
        while stack:
            n, m = stack.pop()
            ml[n] = m
            if not is_leaf[n]:
                stack.append((near[n], far[n]))  # near's miss = its far sibling
                stack.append((far[n], m))        # far's miss = parent's miss
        miss_link[octant] = ml
    return hit_link, miss_link


def bvh_stats(bvh: BVHArrays) -> dict:
    """Node, leaf and split-axis counts of a built tree."""
    count = bvh.prim_count
    interior = int((count == 0).sum())
    leaves = int((count > 0).sum())
    ax = bvh.split_axis[count == 0]
    return {
        "nodes": int(bvh.n_nodes),
        "interior": interior,
        "leaves": leaves,
        "split_x": int((ax == 0).sum()),
        "split_y": int((ax == 1).sum()),
        "split_z": int((ax == 2).sum()),
        "max_leaf_size": int(count.max()),
        "mean_leaf_size": float(count[count > 0].mean()),
    }


def validate_bvh(bvh: BVHArrays, tri_lo: np.ndarray, tri_hi: np.ndarray,
                 n_prims: int) -> None:
    """Check a built tree's structure; raise AssertionError on the first
    broken invariant: the leaf ranges tile the primitives, ``perm`` is a
    bijection, every child box lies inside its parent's (the left child at
    ``n + 1``, the right one in ``second_child``), and every leaf box bounds
    its (reordered) primitives."""
    count = bvh.prim_count
    offset = bvh.prim_offset
    is_leaf = count > 0
    covered = np.zeros(n_prims, np.int32)
    for n in np.nonzero(is_leaf)[0]:
        covered[offset[n]:offset[n] + count[n]] += 1
    assert (covered == 1).all(), "leaf ranges must tile the primitive array"
    assert np.array_equal(np.sort(bvh.perm), np.arange(n_prims))
    for n in np.nonzero(~is_leaf)[0]:
        l, r = n + 1, bvh.second_child[n]
        assert 0 < r < bvh.n_nodes
        for c in (l, r):
            assert (bvh.lo[c] >= bvh.lo[n] - 1e-5).all()
            assert (bvh.hi[c] <= bvh.hi[n] + 1e-5).all()
    plo = tri_lo[bvh.perm]
    phi = tri_hi[bvh.perm]
    for n in np.nonzero(is_leaf)[0]:
        s, e = offset[n], offset[n] + count[n]
        assert (plo[s:e] >= bvh.lo[n] - 1e-5).all()
        assert (phi[s:e] <= bvh.hi[n] + 1e-5).all()
