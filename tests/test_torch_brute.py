"""The port's remaining public functions against the JAX package:
``ray_aabb`` and ``intersect_triangles_brute`` (ops/intersect.py), the
brute-force oracle held against the JAX one and the port's own walk
(``closest_hit``, ``any_hit``) held against the oracle on the cases of
tests/test_traverse.py that need no reference data, the ``BVHDevice``
triangle views, and ``native.build_library``."""

import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tyrant_tpu.ops import intersect as jint
from tyrant_tpu.ops import traverse as jtrav
from tyrant_tpu.scene import bvh as jbvh
from tyrant_tpu_torch import native
from tyrant_tpu_torch.config import EPSILON, VERY_FAR
from tyrant_tpu_torch.ops import intersect, traverse
from tyrant_tpu_torch.scene import bvh as tbvh
from tyrant_tpu_torch.scene.procgen import benchmark_scene

from .test_bvh import random_tri_soup, tri_bounds

TIE = 1e-5  # hit distances this close: either triangle is the closest


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One PyTorch thread: beside the other test workers the default of a
    thread a core oversubscribes the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def random_rays(n, seed=0, spread=12.0):
    """tests/test_traverse.py's rays, as numpy."""
    r = np.random.default_rng(seed + 1000)
    o = r.uniform(-spread, spread, (n, 3)).astype(np.float32)
    d = r.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


def make_device_bvh(n_tris, seed=0, size=0.5):
    """The port's BVHDevice over test_traverse's triangle soup, with the
    edge-form triangles in their original order and the BVH's perm."""
    v0, v1, v2 = random_tri_soup(n_tris, seed=seed, size=size)
    return _device(v0, v1, v2)


def _device(v0, v1, v2):
    lo, hi = tri_bounds(v0, v1, v2)
    b = tbvh.build_bvh(lo, hi)
    dev = traverse.BVHDevice.from_host(b, v0, v1 - v0, v2 - v0, "cpu")
    return dev, (v0, v1 - v0, v2 - v0), b.perm


def check_against_brute(t_bvh, id_bvh, t_bf, id_bf, perm) -> int:
    """The walk's hits against the oracle's: the same hits and misses, t
    within rtol 1e-5, and the same triangle (leaf order mapped back
    through ``perm``) except ties at |dt| <= TIE, whose count is
    returned."""
    t_bvh, id_bvh = t_bvh.numpy(), id_bvh.numpy()
    t_bf, id_bf = t_bf.numpy(), id_bf.numpy()
    np.testing.assert_array_equal(id_bvh >= 0, id_bf >= 0)
    hits = id_bf >= 0
    np.testing.assert_allclose(t_bvh[hits], t_bf[hits], rtol=1e-5)
    differ = hits & (perm[np.maximum(id_bvh, 0)] != id_bf)
    assert (np.abs(t_bvh - t_bf)[differ] <= TIE).all()
    return int(differ.sum())


def test_ray_aabb_matches_jax():
    r = np.random.default_rng(5)
    n = 4096
    o = r.uniform(-4, 4, (n, 3)).astype(np.float32)
    lo = r.uniform(-3, 1, (n, 3)).astype(np.float32)
    hi = (lo + r.uniform(0, 2, (n, 3))).astype(np.float32)
    d = r.normal(size=(n, 3)).astype(np.float32)
    d[: n // 2] = ((lo + hi) / 2 - o)[: n // 2]  # half aimed at the box
    d[::97, 1] = 0.0  # axis-parallel rays: an infinite inverse
    inv = (1.0 / np.where(d == 0, 1e-30, d)).astype(np.float32)
    neg = d < 0
    t_max = r.uniform(0, 8, n).astype(np.float32)
    want = np.asarray(jint.ray_aabb(*(jnp.asarray(a) for a in
                                      (o, inv, neg, lo, hi, t_max))))
    got = intersect.ray_aabb(*(_t(a) for a in (o, inv, neg, lo, hi, t_max)))
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0.05 < want.mean() < 0.95
    # the slab entry and exit distances behind the flags, within 1e-6
    near = np.where(neg, hi, lo)
    far = np.where(neg, lo, hi)
    for plane in (near, far):
        j = np.asarray((jnp.asarray(plane) - jnp.asarray(o))
                       * jnp.asarray(inv))
        p = ((_t(plane) - _t(o)) * _t(inv)).numpy()
        fin = np.isfinite(j)
        np.testing.assert_array_equal(np.isfinite(p), fin)
        np.testing.assert_allclose(p[fin], j[fin], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("t_max", [None, 150.0])
def test_brute_matches_jax_on_a_terrain(t_max, monkeypatch):
    v0, v1, v2 = benchmark_scene(2_000)
    e1, e2 = v1 - v0, v2 - v0
    lo, hi = v0.min(0), v0.max(0)
    r = np.random.default_rng(11)
    n = 4096
    o = (lo + (hi - lo) * r.uniform(-0.2, 1.2, (n, 3))).astype(np.float32)
    o[:, 2] = hi[2] + r.uniform(1, 30, n)  # above the terrain
    tgt = lo + (hi - lo) * r.uniform(0.1, 0.9, (n, 3))
    d = (tgt - o).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tm = None if t_max is None else np.full(n, t_max, np.float32)
    monkeypatch.setattr(intersect, "BRUTE_CHUNK_PAIRS", 1 << 18)  # chunks
    jt, jid = jint.intersect_triangles_brute(
        *(jnp.asarray(a) for a in (o, d, v0, e1, e2)),
        t_max=None if tm is None else jnp.asarray(tm))
    jt, jid = np.asarray(jt), np.asarray(jid)
    tt, tid = intersect.intersect_triangles_brute(
        *(_t(a) for a in (o, d, v0, e1, e2)),
        t_max=None if tm is None else _t(tm))
    assert tid.dtype == torch.int32 and tt.dtype == torch.float32
    np.testing.assert_array_equal(tid.numpy(), jid)
    hits = jid >= 0
    assert (0.5 if t_max is None else 0.05) < hits.mean() < 1.0
    np.testing.assert_allclose(tt.numpy()[hits], jt[hits], rtol=1e-5)
    assert (tt.numpy()[~hits] == np.float32(VERY_FAR)).all()


def test_brute_chunks_alike(monkeypatch):
    """The chunking changes nothing: one chunk a ray, and all at once."""
    v0, v1, v2 = random_tri_soup(50, seed=3)
    o, d = random_rays(64, seed=3)
    args = [_t(a) for a in (o, d, v0, v1 - v0, v2 - v0)]
    b = intersect.intersect_triangles_brute(*args)
    monkeypatch.setattr(intersect, "BRUTE_CHUNK_PAIRS", 1)
    a = intersect.intersect_triangles_brute(*args)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.parametrize("n_tris,n_rays", [(1, 64), (7, 256), (300, 512)])
def test_closest_hit_matches_brute_force(n_tris, n_rays):
    dev, (tv, te1, te2), perm = make_device_bvh(n_tris, seed=n_tris)
    o, d = (_t(a) for a in random_rays(n_rays, seed=n_tris))
    t_bvh, id_bvh = traverse.closest_hit(o, d, dev)
    t_bf, id_bf = intersect.intersect_triangles_brute(o, d, _t(tv), _t(te1),
                                                      _t(te2))
    ties = check_against_brute(t_bvh, id_bvh, t_bf, id_bf, perm)
    assert ties == 0, f"{ties} ties"


def test_closest_hit_on_a_terrain_matches_brute_force():
    """test_traverse's dragon case on a procedural terrain: rays from
    above aimed at triangle centroids mostly hit, the walk agrees with the
    oracle, ties at |dt| <= 1e-5 counted."""
    v0, v1, v2 = benchmark_scene(2_000)
    dev, (tv, te1, te2), perm = _device(v0, v1, v2)
    r = np.random.default_rng(7)
    n = 1024
    centre = v0.mean(0)
    o = np.tile(centre + np.array([0, -60, 40], np.float32), (n, 1))
    f = r.integers(0, v0.shape[0], n)
    target = (v0[f] + v1[f] + v2[f]) / 3
    d = (target - o).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o, d = _t(o.astype(np.float32)), _t(d)
    t_bvh, id_bvh = traverse.closest_hit(o, d, dev)
    t_bf, id_bf = intersect.intersect_triangles_brute(o, d, _t(tv), _t(te1),
                                                      _t(te2))
    assert (id_bf >= 0).float().mean() > 0.5
    ties = check_against_brute(t_bvh, id_bvh, t_bf, id_bf, perm)
    assert ties <= n // 100, f"{ties} ties of {n}"


@pytest.mark.parametrize("size", [0.5, 4.0])
def test_any_hit_matches_brute_force(size):
    """test_traverse's case (size 0.5: no ray is occluded), and with
    triangles eight times as wide, where about a third are."""
    dev, (tv, te1, te2), _ = make_device_bvh(200, seed=11, size=size)
    o, d = (_t(a) for a in random_rays(400, seed=11))
    t_bf, _ = intersect.intersect_triangles_brute(o, d, _t(tv), _t(te1),
                                                  _t(te2))
    max_dist = torch.full((400,), 8.0)
    occ = traverse.any_hit(o, d, max_dist, dev)
    want = (t_bf < VERY_FAR) & (8.0 - t_bf > EPSILON)
    assert int(want.sum()) < 400 and (size < 1 or int(want.sum()) > 50)
    assert torch.equal(occ, want)


@pytest.mark.parametrize("size", [0.5, 4.0])
def test_t_init_seeding(size):
    """A closest distance seeded just below each oracle hit leaves nothing
    strictly closer by more than EPSILON (test_traverse's soup, and one
    with wider triangles, where rays hit)."""
    dev, (tv, te1, te2), _ = make_device_bvh(100, seed=21, size=size)
    o, d = (_t(a) for a in random_rays(100, seed=21))
    t_bf, _ = intersect.intersect_triangles_brute(o, d, _t(tv), _t(te1),
                                                  _t(te2))
    hits = t_bf < VERY_FAR
    assert size < 1 or int(hits.sum()) > 10
    t_init = torch.where(hits, t_bf - 2 * EPSILON, torch.ones_like(t_bf))
    _, id2 = traverse.closest_hit(o, d, dev, t_init=t_init)
    assert (id2 == -1).all()


def test_bvh_device_triangle_views_match_jax():
    v0, v1, v2 = random_tri_soup(300, seed=4)
    lo, hi = tri_bounds(v0, v1, v2)
    jdev = jtrav.BVHDevice.from_host(jbvh.build_bvh(lo, hi), v0, v1 - v0,
                                     v2 - v0)
    tdev, _, _ = _device(v0, v1, v2)
    for name in ("tri_vert", "tri_e1", "tri_e2"):
        want = np.asarray(getattr(jdev, name))
        got = getattr(tdev, name).numpy()
        assert got.shape == want.shape and got.dtype == want.dtype, name
        assert got.tobytes() == want.tobytes(), name


def test_build_library_is_what_get_lib_loads():
    path = native.build_library()
    assert path == str(native.library_path())
    lib = native.get_lib()
    assert isinstance(lib, ctypes.CDLL) and lib._name == path
