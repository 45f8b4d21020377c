"""The port's breadth-first closest hit (the plain version of
``csrc/stream.cu``, which the wrapper runs on CPU tensors) against the JAX
package: the Pallas stream kernel in interpret mode and the XLA
depth-first walk.  Ids agree except epsilon ties (an id differs and
|dt| > 1e-3 is a mismatch); t within rtol 1e-4 and atol 1e-3 on hits."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tyrant_tpu.ops.pallas.stream_kernel import \
    closest_hit_stream as j_stream
from tyrant_tpu.ops.pallas.traverse_kernel import PacketTables as JPacketTables
from tyrant_tpu.ops.traverse import closest_hit as j_closest
from tyrant_tpu.scene.procgen import terrain
from tyrant_tpu.scene.scene import Scene as JScene
from tyrant_tpu_torch.bench import equivalence
from tyrant_tpu_torch.ops import stream as pstream
from tyrant_tpu_torch.ops import traverse as walk
from tyrant_tpu_torch.ops.kernels import stream as kstream
from tyrant_tpu_torch.ops.kernels import traverse as ktrav
from tyrant_tpu_torch.scene.scene import Scene

N_HEAVY = 1000  # not a multiple of 128: the JAX kernel's pad lanes


def _scenes(n_quads, towers):
    v0, v1, v2 = terrain(n_quads=n_quads, towers=towers)
    jd = JScene.from_triangles(v0, v1, v2, builder="numpy").to_device()
    td = Scene.from_triangles(v0, v1, v2, builder="numpy").to_device("cpu")
    return jd, td, ktrav.PacketTables(td.bvh)


def _rays(bvh, n, seed):
    """bench.py's recipe: half box-random, half aimed into the mesh."""
    return equivalence.gate_rays(bvh, n, seed)[:2]


@pytest.fixture(scope="module")
def heavy():
    """terrain(16, 2), 1,000 hit-heavy rays, t_init on every third ray."""
    jd, td, tables = _scenes(16, 2)
    o, d = _rays(td.bvh, N_HEAVY, 11)
    t0 = np.full(N_HEAVY, 1e20, np.float32)
    t0[::3] = np.random.default_rng(3).uniform(
        5.0, 200.0, (N_HEAVY + 2) // 3).astype(np.float32)
    return jd, td, tables, o, d, t0


def _t(*xs):
    return [torch.from_numpy(x) for x in xs]


def _assert_tie_rule(t, ids, t_ref, id_ref):
    bad = (ids != id_ref) & (np.abs(t - t_ref) > 1e-3)
    assert not bad.any(), f"id mismatches beyond ties on {int(bad.sum())}"
    hits = id_ref >= 0
    np.testing.assert_allclose(t[hits], t_ref[hits], rtol=1e-4, atol=1e-3)
    return hits.mean()


def test_matches_pallas_stream_interpret(heavy):
    jd, td, tables, o, d, t0 = heavy
    t_j, id_j = (np.asarray(x) for x in j_stream(
        jnp.asarray(o), jnp.asarray(d), JPacketTables(jd.bvh),
        t_init=jnp.asarray(t0), interpret=True, cap_mult=8))
    np.testing.assert_array_equal(tables.rows.numpy(),
                                  np.asarray(JPacketTables(jd.bvh).rows))
    t, ids = (x.numpy() for x in kstream.closest_hit_stream(
        *_t(o, d), tables, torch.from_numpy(t0), cap_mult=8))
    assert _assert_tie_rule(t, ids, t_j, id_j) > 0.15
    # rays without a hit keep their t_init exactly
    np.testing.assert_array_equal(t[ids < 0], t0[ids < 0])


@pytest.mark.parametrize("with_t_init", [False, True])
def test_matches_xla_walk(with_t_init):
    jd, td, tables = _scenes(32, 3)
    o, d = _rays(td.bvh, 2048, 5)
    t0 = None
    if with_t_init:  # every third ray starts from a nearer t
        t0 = np.full(2048, 1e20, np.float32)
        t0[::3] = np.random.default_rng(8).uniform(20.0, 300.0, 683)
    t_ref, id_ref = (np.asarray(x) for x in j_closest(
        jnp.asarray(o), jnp.asarray(d), jd.bvh,
        t_init=None if t0 is None else jnp.asarray(t0)))
    t, ids = (x.numpy() for x in kstream.closest_hit_stream(
        *_t(o, d), tables, None if t0 is None else torch.from_numpy(t0)))
    assert _assert_tie_rule(t, ids, t_ref, id_ref) > 0.15
    # and against the port's own depth-first walk
    t_w, id_w = (x.numpy() for x in walk.closest_hit(
        *_t(o, d), td.bvh, None if t0 is None else torch.from_numpy(t0)))
    _assert_tie_rule(t, ids, t_w, id_w)


def test_all_miss_gives_minus_one():
    _, td, tables = _scenes(8, 1)
    n = 256
    o = torch.full((n, 3), 1e6)
    d = torch.tensor([[0.0, 0.0, 1.0]]).repeat(n, 1)
    stats = {}
    t, ids = kstream.closest_hit_stream(o, d, tables, stats=stats)
    assert (ids == -1).all() and (t == 1e20).all()
    assert stats["levels"] == 1 and stats["pairs"] == [n]
    assert stats["tri_tests"] == 0 and stats["box_tests"] == 2 * n


def test_overflow_flag_and_raise(heavy):
    jd, td, tables, o, d, t0 = heavy
    stats = {}
    t, ids, ovf = kstream.closest_hit_stream(
        *_t(o, d), tables, torch.from_numpy(t0), cap_mult=1,
        return_overflow=True, stats=stats)
    assert int(ovf) == 1 and ovf.dtype == torch.int32
    assert max(stats["pairs"]) > pstream.capacity(N_HEAVY, 1)
    assert torch.isfinite(t).all()
    with pytest.raises(RuntimeError, match="frontier overflow"):
        kstream.closest_hit_stream(*_t(o, d), tables, torch.from_numpy(t0),
                                   cap_mult=1)
    *_, j_ovf = j_stream(jnp.asarray(o), jnp.asarray(d),
                         JPacketTables(jd.bvh), t_init=jnp.asarray(t0),
                         interpret=True, cap_mult=1, return_overflow=True)
    assert int(j_ovf) == 1
    # a capacity above the peak frontier clears the flag
    big = {}
    *_, ovf2 = kstream.closest_hit_stream(
        *_t(o, d), tables, torch.from_numpy(t0), cap_mult=8,
        return_overflow=True, stats=big)
    assert int(ovf2) == 0 and max(big["pairs"]) <= pstream.capacity(N_HEAVY, 8)


def test_stats_count_the_work(heavy):
    _, td, tables, o, d, t0 = heavy
    stats = {}
    kstream.closest_hit_stream(*_t(o, d), tables, torch.from_numpy(t0),
                               stats=stats)
    assert stats["pairs"][0] == N_HEAVY
    assert len(stats["pairs"]) == stats["levels"] <= tables.max_depth
    assert stats["box_tests"] == 2 * sum(stats["pairs"])
    assert stats["tri_tests"] > 0


def test_chunked_levels_give_the_same_result(heavy):
    """Levels cut into chunks (as the 2M-ray queues on the card are) give
    the same t bit for bit, the same ids and the same pairs a level."""
    _, _, tables, o, d, t0 = heavy
    outs = []
    for chunk in (pstream.CHUNK, 97):
        stats = {}
        t, ids, _ = pstream.closest_hit_stream(
            *_t(o, d), tables.rows, tables.max_depth,
            torch.from_numpy(t0), stats=stats, chunk=chunk)
        outs.append((t.view(torch.int32), ids, stats))
    (t_a, id_a, s_a), (t_b, id_b, s_b) = outs
    assert torch.equal(t_a, t_b) and torch.equal(id_a, id_b) and s_a == s_b


def test_one_node_tree():
    """A mesh of one leaf: the pseudo-root row holds it on the left and an
    inverted box on the right."""
    v0 = np.array([[-1, -1, 0], [1, -1, 0]], np.float32)
    v1 = np.array([[1, -1, 0], [1, 1, 0]], np.float32)
    v2 = np.array([[-1, 1, 0], [-1, 1, 0]], np.float32)
    td = Scene.from_triangles(v0, v1, v2, builder="numpy").to_device("cpu")
    tables = ktrav.PacketTables(td.bvh)
    assert tables.rows.shape[0] == 1 and tables.max_depth == 2
    g = np.random.default_rng(1)
    o = np.concatenate([g.uniform(-1.5, 1.5, (200, 2)),
                        np.full((200, 1), 5.0)], 1).astype(np.float32)
    d = np.tile(np.array([[0.0, 0.0, -1.0]], np.float32), (200, 1))
    d[::2] = -d[::2]  # half look away: back faces and misses
    t, ids = kstream.closest_hit_stream(*_t(o, d), tables)
    t_w, id_w = walk.closest_hit(*_t(o, d), td.bvh)
    assert 0 < int((ids >= 0).sum()) < 100
    np.testing.assert_array_equal(ids.numpy(), id_w.numpy())
    np.testing.assert_array_equal(t.numpy(), t_w.numpy())


def test_pack_orders_by_t_then_id():
    t = torch.tensor([2.0, 1.0, 1.0, 3e-3, 1e20])
    ids = torch.tensor([0, 7, 3, 9, pstream.NO_HIT], dtype=torch.int32)
    keys = pstream.pack(t, ids)
    assert keys.argsort().tolist() == [3, 2, 1, 0, 4]
    t2, id2 = pstream.unpack(keys)
    assert torch.equal(t2, t) and id2.tolist() == [0, 7, 3, 9, -1]


def test_capacity_rounds_as_the_jax_kernel():
    # cap_mult x rays padded to 128, in 128-pair tiles rounded up to 8
    assert pstream.capacity(N_HEAVY, 1) == 1024
    assert pstream.capacity(100, 3) == 1024
    assert pstream.capacity(65_536, 8) == 524_288
    assert pstream.capacity(2_097_152, 3) == 6_291_456


def test_frontier_deeper_than_the_table_raises():
    _, td, tables = _scenes(8, 1)
    o, d = _rays(td.bvh, 64, 2)
    with pytest.raises(RuntimeError, match="outlived"):
        pstream.closest_hit_stream(*_t(o, d), tables.rows, 1)


def test_wrapper_rejects_bad_inputs():
    _, td, tables = _scenes(8, 1)
    o, d = _t(*_rays(td.bvh, 16, 2))
    with pytest.raises(ValueError, match="float32"):
        kstream.closest_hit_stream(o.double(), d, tables)
    with pytest.raises(ValueError, match="cap_mult"):
        kstream.closest_hit_stream(o, d, tables, cap_mult=0)


def test_cpu_tensors_launch_nothing(heavy):
    _, _, tables, o, d, _ = heavy
    before = kstream.launches
    kstream.closest_hit_stream(*_t(o, d), tables)
    assert kstream.launches == before == 0
