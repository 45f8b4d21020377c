"""The port's plain traversal against the JAX package: the XLA threaded
walk (same algorithm: ids and flags exact) and the Pallas packet kernel of
both generations, mono and wave, in interpret mode (a different visiting
order: ids exact except epsilon ties with |dt| <= 1e-3, t within rtol
1e-4 on hits, any-hit flags exact)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tyrant_tpu.ops.pallas.traverse_kernel import (PacketTables as JPacketTables,
                                                   any_hit_packets as j_any_pk,
                                                   closest_hit_packets as j_closest_pk)
from tyrant_tpu.ops.traverse import any_hit as j_any
from tyrant_tpu.ops.traverse import closest_hit as j_closest
from tyrant_tpu.scene.procgen import terrain
from tyrant_tpu.scene.scene import Scene as JScene
from tyrant_tpu_torch.ops import traverse as plain
from tyrant_tpu_torch.ops.kernels import traverse as ktrav
from tyrant_tpu_torch.scene.scene import Scene


def _setup(n_rays=2048, seed=3):
    v0, v1, v2 = terrain(n_quads=32, towers=3)
    jd = JScene.from_triangles(v0, v1, v2, builder="numpy").to_device()
    td = Scene.from_triangles(v0, v1, v2, builder="numpy").to_device("cpu")
    r = np.random.default_rng(seed)
    lo = np.asarray(jd.bvh.node_packed)[0, 0:3]
    hi = np.asarray(jd.bvh.node_packed)[0, 3:6]
    # half box-random, half aimed into the mesh (bench.py's recipe) ...
    o = (lo + (hi - lo) * r.uniform(-0.2, 1.2, (n_rays, 3))).astype(np.float32)
    d = r.normal(size=(n_rays, 3)).astype(np.float32)
    half = n_rays // 2
    tgt = lo + (hi - lo) * r.uniform(0.2, 0.8, (half, 3))
    d[half:] = (tgt - o[half:]).astype(np.float32)
    # ... plus axis-aligned rays starting on the root box's planes, where
    # (b - o) * inv is 0 * inf = NaN on some slabs
    k = min(64, n_rays // 4)
    o[:k] = lo + (hi - lo) * r.uniform(0, 1, (k, 3))
    axis = r.integers(0, 3, k)
    o[np.arange(k), axis] = np.where(r.random(k) < 0.5, lo[axis], hi[axis])
    d[:k] = 0.0
    d[np.arange(k), (axis + 1) % 3] = np.where(r.random(k) < 0.5, 1.0, -1.0)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return jd, td, o, d.astype(np.float32)


def test_closest_matches_xla_walk():
    jd, td, o, d = _setup()
    t_ref, id_ref = (np.asarray(x) for x in j_closest(jnp.asarray(o),
                                                     jnp.asarray(d), jd.bvh))
    t, ids = plain.closest_hit(torch.from_numpy(o), torch.from_numpy(d), td.bvh)
    hits = id_ref >= 0
    assert hits.mean() > 0.2
    np.testing.assert_array_equal(ids.numpy(), id_ref)
    np.testing.assert_allclose(t.numpy()[hits], t_ref[hits], rtol=1e-5)


def test_closest_with_t_init_matches_xla_walk():
    jd, td, o, d = _setup(seed=9)
    t_init = np.full((o.shape[0],), 80.0, np.float32)
    t_ref, id_ref = (np.asarray(x) for x in j_closest(
        jnp.asarray(o), jnp.asarray(d), jd.bvh, t_init=jnp.asarray(t_init)))
    t, ids = plain.closest_hit(torch.from_numpy(o), torch.from_numpy(d),
                               td.bvh, torch.from_numpy(t_init))
    np.testing.assert_array_equal(ids.numpy(), id_ref)
    np.testing.assert_allclose(t.numpy(), t_ref, rtol=1e-5)


def test_any_hit_matches_xla_walk():
    jd, td, o, d = _setup(seed=5)
    maxd = np.full((o.shape[0],), 120.0, np.float32)
    maxd[::7] = 0.0  # dead shadow slots
    active = np.arange(o.shape[0]) % 3 != 0
    occ_ref = np.asarray(j_any(jnp.asarray(o), jnp.asarray(d),
                               jnp.asarray(maxd), jd.bvh,
                               active=jnp.asarray(active)))
    occ = plain.any_hit(torch.from_numpy(o), torch.from_numpy(d),
                        torch.from_numpy(maxd), td.bvh,
                        active=torch.from_numpy(active))
    assert occ_ref.any() and not occ_ref.all()
    np.testing.assert_array_equal(occ.numpy(), occ_ref)


@pytest.mark.parametrize("wave", [False, True])
def test_matches_pallas_packet_kernel_interpret(wave):
    jd, td, o, d = _setup(seed=11)
    jt = JPacketTables(jd.bvh)
    tables = ktrav.PacketTables(td.bvh)
    t_pk, id_pk = (np.asarray(x) for x in j_closest_pk(
        jnp.asarray(o), jnp.asarray(d), jt, interpret=True, wave=wave))
    # the CPU wrapper runs the plain version, whatever the generation
    t, ids = ktrav.closest_hit_packets(torch.from_numpy(o),
                                       torch.from_numpy(d), tables, wave=wave)
    t, ids = t.numpy(), ids.numpy()
    tie = np.abs(t - t_pk) <= 1e-3
    assert ((ids == id_pk) | tie).all()
    np.testing.assert_array_equal(ids >= 0, id_pk >= 0)
    hits = id_pk >= 0
    np.testing.assert_allclose(t[hits], t_pk[hits], rtol=1e-4)
    maxd = np.where(hits, t_pk * 0.999, 300.0).astype(np.float32)
    occ_pk = np.asarray(j_any_pk(jnp.asarray(o), jnp.asarray(d),
                                 jnp.asarray(maxd), jt, interpret=True,
                                 wave=wave))
    occ = ktrav.any_hit_packets(torch.from_numpy(o), torch.from_numpy(d),
                                torch.from_numpy(maxd), tables, wave=wave)
    np.testing.assert_array_equal(occ.numpy(), occ_pk)
    # CPU tensors never reach a kernel
    assert ktrav.launches == ktrav.launches_wave == 0


def test_unsupported_table_raises():
    _, td, o, d = _setup(n_rays=8)
    # a chain of interior rows deeper than the kernel's stack
    depth = ktrav.STACK_DEPTH
    rows = np.zeros((depth, ktrav.ROW_WIDTH), np.float32)
    rows[:-1, ktrav._L_TAG] = -1.0
    rows[:-1, ktrav._L_REF] = np.arange(1, depth)
    tables = ktrav.PacketTables(td.bvh, rows=rows)
    assert not tables.supported
    with pytest.raises(ValueError, match="unsupported"):
        ktrav.closest_hit_packets(torch.from_numpy(o), torch.from_numpy(d),
                                  tables)
    from tyrant_tpu_torch.config import small_config
    from tyrant_tpu_torch.render import Renderer
    with pytest.raises(ValueError, match="unsupported"):
        Renderer(td, small_config(16, 16, 1024), device="cpu", tables=tables)


def test_wrapper_rejects_bad_inputs():
    _, td, o, d = _setup(n_rays=8)
    tables = ktrav.PacketTables(td.bvh)
    with pytest.raises(ValueError, match="float32"):
        ktrav.closest_hit_packets(torch.from_numpy(o).double(),
                                  torch.from_numpy(d), tables)
    with pytest.raises(ValueError, match="contiguous"):
        ktrav.closest_hit_packets(torch.from_numpy(o).t().contiguous().t(),
                                  torch.from_numpy(d), tables)



def test_walk_counts_the_work_it_needs():
    """stats= counts what the bound is computed from: each live ray tests
    at least the root box, the rows read include the root, the counts are
    the same for closest and any hit on rays that miss everything, and
    dead shadow rays need nothing."""
    _, td, o, d = _setup(seed=13)
    o, d = torch.from_numpy(o), torch.from_numpy(d)
    n = o.shape[0]
    stats = {}
    plain.closest_hit(o, d, td.bvh, stats=stats)
    assert stats["box_tests"] >= n and stats["tri_tests"] > 0
    rows = stats["rows"]
    assert rows.dtype == torch.bool and rows.shape == (td.bvh.n_nodes,)
    assert bool(rows[0]) and 1 < int(rows.sum()) < td.bvh.n_nodes
    dead = {}
    plain.any_hit(o, d, torch.zeros(n), td.bvh,
                  active=torch.zeros(n, dtype=torch.bool), stats=dead)
    assert dead["box_tests"] == dead["tri_tests"] == 0
    assert not bool(dead["rows"].any())
