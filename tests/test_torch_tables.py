"""The kernel-side traversal table (64-byte node records and 48-byte
triangle records, ``ops/kernels/traverse.build_kernel_tables``) against the
fat rows it is made from: decoded in numpy it gives back every lane of
``rows`` bit for bit, for a terrain, a one-leaf tree, the spheres-only stub
and a table handed in from the JAX package through interop; its alignment
and size are what the kernels' vector loads need.  Also the per-ray visit
counts of the plain walk's ``stats=``."""

import numpy as np
import pytest
import torch

from tyrant_tpu.ops.pallas.traverse_kernel import PacketTables as JPacketTables
from tyrant_tpu.scene.procgen import terrain
from tyrant_tpu.scene.scene import Scene as JScene
from tyrant_tpu_torch import interop
from tyrant_tpu_torch.ops import traverse as plain
from tyrant_tpu_torch.ops.kernels import traverse as ktrav
from tyrant_tpu_torch.scene.scene import Scene

_BVH = ("node_packed", "miss_flat", "tri_packed", "leaf_packed")


def _bits(a):
    return np.ascontiguousarray(a).view(np.uint32)


def rows_from_kernel_tables(nodes: np.ndarray, tris: np.ndarray) -> np.ndarray:
    """The fat rows [R, 128] f32 that ``nodes`` [R, 16] i32 and ``tris``
    [T, 12] f32 encode."""
    n = nodes.shape[0]
    rows = np.zeros((n, ktrav.ROW_WIDTH), np.float32)
    rows[:, 0:12] = np.ascontiguousarray(nodes[:, 0:12]).view(np.float32)
    meta = nodes[:, 12]
    tags = np.stack([(meta & 0xff).astype(np.int8),
                     ((meta >> 8) & 0xff).astype(np.int8)], 1).astype(np.int32)
    refs = nodes[:, 13:15]
    rows[:, [ktrav._L_TAG, ktrav._R_TAG]] = tags
    rows[:, [ktrav._L_REF, ktrav._R_REF]] = refs
    rows[:, ktrav._AXIS] = (meta >> 16) & 3
    for side, tri_c in ((0, ktrav._L_TRI), (1, ktrav._R_TRI)):
        for j in range(ktrav.LEAF_WIDTH):
            has = tags[:, side] > j
            rows[has, tri_c + 9 * j:tri_c + 9 * j + 9] = \
                tris[refs[has, side] + j, 0:9]
    return rows


def _tables(case):
    if case == "terrain":
        sd = Scene.from_triangles(*terrain(n_quads=24, towers=3),
                                  builder="numpy").to_device("cpu")
        return ktrav.PacketTables(sd.bvh)
    if case == "one-leaf":  # build_rows' pseudo-root: the lone leaf on the left
        v = np.array([[0.0, 0.0, 0.0], [3.0, 0.0, 1.0]], np.float32)
        sd = Scene.from_triangles(v, v + [1, 0, 0], v + [0, 1, 0],
                                  builder="numpy").to_device("cpu")
        return ktrav.PacketTables(sd.bvh)
    if case == "spheres-only":
        return ktrav.PacketTables(Scene.load(None).to_device("cpu").bvh)
    assert case == "interop"
    jd = JScene.from_triangles(*terrain(n_quads=16, towers=2),
                               builder="numpy").to_device()
    leaves = {k: np.asarray(getattr(jd.bvh, k)) for k in _BVH}
    leaves.update({k: np.asarray(getattr(jd, k))
                   for k in interop.SCENE_LEAVES[4:]})
    _, tables = interop.scene_from_numpy(
        leaves, np.asarray(JPacketTables(jd.bvh).rows), "cpu")
    return tables


CASES = ["terrain", "one-leaf", "spheres-only", "interop"]


@pytest.mark.parametrize("case", CASES)
def test_kernel_tables_decode_to_rows(case):
    tables = _tables(case)
    rows = tables.rows.numpy()
    if case in ("one-leaf", "spheres-only"):
        assert rows.shape[0] == 1
    got = rows_from_kernel_tables(tables.nodes.numpy(), tables.tris.numpy())
    np.testing.assert_array_equal(_bits(got), _bits(rows))
    # field by field, as the kernels read them
    nodes = tables.nodes.numpy()
    np.testing.assert_array_equal(_bits(nodes[:, 0:12]), _bits(rows[:, 0:12]))
    np.testing.assert_array_equal((nodes[:, 12] >> 16) & 3,
                                  rows[:, ktrav._AXIS].astype(np.int32))
    np.testing.assert_array_equal(nodes[:, 13], rows[:, ktrav._L_REF])
    np.testing.assert_array_equal(nodes[:, 14], rows[:, ktrav._R_REF])
    assert not nodes[:, 15].any() and not tables.tris.numpy()[:, 9:].any()


@pytest.mark.parametrize("case", CASES)
def test_kernel_tables_alignment_and_size(case):
    tables = _tables(case)
    rows = tables.rows.numpy()
    nodes, tris = tables.nodes, tables.tris
    assert nodes.dtype == torch.int32 and tris.dtype == torch.float32
    assert nodes.is_contiguous() and tris.is_contiguous()
    assert tuple(nodes.shape) == (rows.shape[0], ktrav.NODE_WORDS)
    assert nodes.data_ptr() % ktrav.NODE_ALIGN == 0  # four 16-byte loads
    assert tris.data_ptr() % 16 == 0                 # three 16-byte loads
    assert nodes.numel() * nodes.element_size() == 64 * rows.shape[0]
    # one 48-byte record per leaf-order prim, up to the last leaf's end
    tags = rows[:, [ktrav._L_TAG, ktrav._R_TAG]]
    refs = rows[:, [ktrav._L_REF, ktrav._R_REF]]
    end = int(np.where(tags > 0, refs + tags, 0).max())
    assert tuple(tris.shape) == (max(end, 1), ktrav.TRI_WORDS)
    assert tris.numel() * tris.element_size() == 48 * max(end, 1)
    if case == "terrain":
        # every prim sits in exactly one leaf: the records are the BVH's
        # leaf-order triangle table
        np.testing.assert_array_equal(
            _bits(tris.numpy()[:, 0:9]),
            _bits(tables.bvh.tri_packed.numpy()[:end, 0:9]))
        assert tris.numel() * 4 + nodes.numel() * 4 < tables.rows.numel() * 4


def _rays(bvh, n, seed):
    r = np.random.default_rng(seed)
    node = bvh.node_packed.numpy()
    lo, hi = node[0, 0:3], node[0, 3:6]
    o = (lo + (hi - lo) * r.uniform(-0.2, 1.2, (n, 3))).astype(np.float32)
    tgt = lo + (hi - lo) * r.uniform(0.2, 0.8, (n, 3))
    d = (tgt - o).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return torch.from_numpy(o), torch.from_numpy(d.astype(np.float32))


@pytest.mark.parametrize("closest", [True, False])
def test_per_ray_visits_sum_to_box_tests(closest):
    bvh = _tables("terrain").bvh
    n = 1000
    o, d = _rays(bvh, n, seed=21)
    stats = {}
    if closest:
        plain.closest_hit(o, d, bvh, stats=stats)
        live = torch.ones(n, dtype=torch.bool)
    else:
        maxd = torch.full((n,), 200.0)
        maxd[::3] = 0.0  # dead slots: no visit
        live = maxd > 0
        plain.any_hit(o, d, maxd, bvh, active=live, stats=stats)
    visits, row_visits = stats["visits"], stats["row_visits"]
    assert visits.dtype == row_visits.dtype == torch.int64
    assert tuple(visits.shape) == tuple(row_visits.shape) == (n,)
    assert int(visits.sum()) == stats["box_tests"] > 0
    assert bool((visits[live] >= 1).all()) and not bool(visits[~live].any())
    # a ray reads a fat row for each interior box it hits, never more than
    # the boxes it tests; together the rays read every row that is marked
    assert bool((row_visits <= visits).all()) and int(row_visits.max()) > 1
    assert int(row_visits.sum()) >= int(stats["rows"].sum())


def test_distinct_triangles_read_are_the_tested_leaves():
    """"tris_read" counts each tested triangle once: the triangles of the
    marked leaves, no more than the tests made and no more than the mesh."""
    bvh = _tables("terrain").bvh
    o, d = _rays(bvh, 1000, seed=22)
    stats = {}
    plain.closest_hit(o, d, bvh, stats=stats)
    leaves = stats["leaves"]
    assert leaves.dtype == torch.bool and tuple(leaves.shape) == (bvh.n_nodes,)
    assert not bool((leaves & stats["rows"]).any())  # a node is one or the other
    meta = bvh.node_packed[:, 6].contiguous().view(torch.int32).long()
    count = meta & plain.META_COUNT_MASK
    assert bool((count[leaves] > 0).all())
    assert stats["tris_read"] == int(count[leaves].sum())
    assert 0 < stats["tris_read"] <= min(stats["tri_tests"],
                                         int(count.sum()))
