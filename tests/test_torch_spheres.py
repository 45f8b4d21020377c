"""The sphere kernel (``csrc/spheres.cu``, ``ops/kernels/spheres.py``)
against its plain version (``ops/intersect.py``: ``intersect_spheres``
for extend's closest hit, ``any_hit_spheres`` OR-ed into the traversal's
flags for connect's any hit), slot for slot, on the same CUDA tensors:

- the queues of the benchmark's cells: ``perftest_1m``'s and
  ``textured_1m``'s extend and shadow queues after a few steps of each of
  the three poses, and ``preset_128k``'s 131,072-slot queues;
- edge cases built by hand: rays on and near the radius-1e4 ground sphere,
  exact ties between equal spheres, rays starting inside a sphere (the far
  root), max distances of 0, below 0 and NaN, one sphere, and a list of
  300 spheres, longer than one block's staging of 256 rows, with a tie
  across the two tiles;
- a scene without spheres, where neither mode launches;
- captured render steps, whose replays launch both modes, with the
  tracer's ``sphere_kernel`` counter at two queues a step.

The closest hit's t and sphere id must be bit for bit the plain version's
and the occluded flags equal, on every slot: the kernel repeats the plain
chain's float32 operations in PyTorch's order on the card, including the
first of equal distances that torch.min keeps.  The kernel has no CPU
mode, so those tests skip without a CUDA device; the CPU tests hold the
gate (a CPU tensor takes the plain version) and the input checks.  This
file imports no JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_spheres.py -s
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from tyrant_tpu_torch import render as tr
from tyrant_tpu_torch.bench.poses import camera_for_pose
from tyrant_tpu_torch.config import RenderConfig, VERY_FAR, small_config
from tyrant_tpu_torch.ops.intersect import any_hit_spheres, intersect_spheres
from tyrant_tpu_torch.ops.kernels import build
from tyrant_tpu_torch.ops.kernels import spheres as kspheres
from tyrant_tpu_torch.scene.procgen import terrain
from tyrant_tpu_torch.scene.scene import Scene, Spheres
from tyrant_tpu_torch.utils import profiling

CONFIGS = Path(__file__).resolve().parents[1] / "perfbench" / "configs"
SEED = 2 ** 31 + 12345  # a run seed above 32 signed bits, as perfbench takes
TILE = 256  # sphere rows csrc/spheres.cu stages a pass (its BLOCK)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the sphere kernel has no CPU mode")
    return torch.device("cuda")


@pytest.fixture(autouse=True)
def _tracer_off():
    yield
    profiling.disable()


def _seven(dev):
    """The seven spheres of the benchmark's configurations: centres [7, 3],
    radii [7] (the ground sphere's radius 1e4 at index 4)."""
    s = Spheres.default_seven()
    return (torch.as_tensor(s.center, device=dev),
            torch.as_tensor(s.radius, device=dev))


def _rays(rng, n: int, dev, lo=(-100, -100, 0), hi=(100, 100, 150)):
    o = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return torch.as_tensor(o, device=dev), torch.as_tensor(d, device=dev)


def _shadow_inputs(rng, n: int, dev):
    """(occluded, max_dist, valid) with every kind of slot: invalid, valid
    and already occluded, max distances 0, below 0, NaN, to infinity and
    in between."""
    kind = rng.integers(0, 8, n)
    maxd = rng.uniform(0.0, 300.0, n).astype(np.float32)
    maxd[kind == 0] = 0.0
    maxd[kind == 1] = -1.0
    maxd[kind == 2] = np.nan
    maxd[kind == 3] = VERY_FAR
    maxd[kind == 4] = 1e-4
    valid = rng.uniform(size=n) < 0.7
    occ = rng.uniform(size=n) < 0.1
    return (torch.as_tensor(occ, device=dev),
            torch.as_tensor(maxd, device=dev),
            torch.as_tensor(valid, device=dev))


def _plain_any(o, d, c, r, occ, maxd, valid):
    return occ | any_hit_spheres(
        o, d, c, r, torch.where(valid, maxd, torch.zeros_like(maxd)))


def compare(label, o, d, c, r, occ, maxd, valid) -> dict:
    """Both modes against the plain version on the same tensors: the
    slots whose t (by its bits), id or occluded flag differ, with the hits
    and the sphere occlusions for the record."""
    t_k, id_k = kspheres.closest(o, d, c, r)
    t_p, id_p = intersect_spheres(o, d, c, r)
    any_k = kspheres.any_hit(o, d, c, r, occ, maxd, valid)
    any_p = _plain_any(o, d, c, r, occ, maxd, valid)
    torch.cuda.synchronize()
    got = dict(t_off=int((t_k.view(torch.int32)
                          != t_p.view(torch.int32)).sum()),
               id_off=int((id_k != id_p).sum()),
               occluded_off=int((any_k != any_p).sum()),
               rays=o.shape[0], spheres=c.shape[0],
               hits=int((id_p >= 0).sum()),
               sphere_occluded=int((any_p & ~occ).sum()))
    print(f"{label}: {json.dumps(got)}")
    return got


def _assert_same(got: dict) -> None:
    assert got["t_off"] == got["id_off"] == got["occluded_off"] == 0, got


# --------------------------------------------------------------------------
# the CPU: the plain version, the checks
# --------------------------------------------------------------------------

def test_cpu_takes_the_plain_version(monkeypatch):
    def no_library():
        raise AssertionError("a CPU tensor built the kernel library")
    monkeypatch.setattr(build, "load", no_library)
    rng = np.random.default_rng(3)
    o, d = _rays(rng, 2048, "cpu")
    c, r = _seven("cpu")
    occ, maxd, valid = _shadow_inputs(rng, 2048, "cpu")
    before = (kspheres.launches_closest, kspheres.launches_any)
    t, ident = kspheres.closest(o, d, c, r)
    t_p, id_p = intersect_spheres(o, d, c, r)
    assert torch.equal(t, t_p) and torch.equal(ident, id_p)
    assert int((ident >= 0).sum()) > 0
    got = kspheres.any_hit(o, d, c, r, occ, maxd, valid)
    want = _plain_any(o, d, c, r, occ, maxd, valid)
    assert torch.equal(got, want) and bool((want & ~occ).any())
    assert (kspheres.launches_closest, kspheres.launches_any) == before


def _inputs():
    rng = np.random.default_rng(5)
    o, d = _rays(rng, 64, "cpu")
    c, r = _seven("cpu")
    occ, maxd, valid = _shadow_inputs(rng, 64, "cpu")
    return dict(origin=o, direction=d, centers=c, radii=r, occluded=occ,
                max_dist=maxd, valid=valid)


# a malformed input of either mode: (mode, input, its replacement)
MALFORMED = {
    "origin_float64": ("closest", "origin",
                       lambda x: x.to(torch.float64)),
    "origin_width_4": ("closest", "origin",
                       lambda x: torch.cat([x, x[:, :1]], 1)),
    "direction_strided": ("closest", "direction",
                          lambda x: torch.cat([x, x], 1)[:, ::2]),
    "direction_short": ("closest", "direction", lambda x: x[:-1]),
    "radii_int": ("closest", "radii", lambda x: x.to(torch.int32)),
    "radii_one_more": ("closest", "radii",
                       lambda x: torch.cat([x, x[:1]])),
    "centers_on_meta": ("closest", "centers", lambda x: x.to("meta")),
    "no_spheres": ("closest", ("centers", "radii"), lambda x: x[:0]),
    "origin_on_meta": ("closest", ("origin", "direction", "centers",
                                   "radii"), lambda x: x.to("meta")),
    "occluded_float": ("any", "occluded", lambda x: x.to(torch.float32)),
    "max_dist_2d": ("any", "max_dist", lambda x: x[:, None]),
    "valid_short": ("any", "valid", lambda x: x[1:]),
    "any_no_spheres": ("any", ("centers", "radii"), lambda x: x[:0]),
}


@pytest.mark.parametrize("case", sorted(MALFORMED))
def test_malformed_inputs_raise(case):
    mode, names, change = MALFORMED[case]
    kw = _inputs()
    for name in (names,) if isinstance(names, str) else names:
        kw[name] = change(kw[name])
    args = [kw[k] for k in ("origin", "direction", "centers", "radii")]
    with pytest.raises(ValueError):
        if mode == "closest":
            kspheres.closest(*args)
        else:
            kspheres.any_hit(*args, kw["occluded"], kw["max_dist"],
                             kw["valid"])


def test_defer_add_sums_a_steps_calls():
    profiling.enable()
    for n in (5, 7):
        profiling.defer_add("sphere_kernel", n)
    profiling.count(torch.device("cpu"))
    assert profiling.snapshot()["counters"]["cpu"]["sphere_kernel"] == 12


def _sphere_free(dev):
    none = Spheres(center=np.zeros((0, 3), np.float32),
                   radius=np.zeros(0, np.float32),
                   color=np.zeros((0, 3), np.float32),
                   emission=np.zeros((0, 3), np.float32),
                   refl=np.zeros(0, np.int32))
    sd = Scene.from_triangles(*terrain(n_quads=8, towers=2), spheres=none,
                              builder="numpy").to_device(dev)
    assert sd.n_spheres == 0
    return sd


def _sphere_free_check(dev) -> None:
    """sphere_pass and _connect on a scene without spheres: every ray a
    miss of the spheres, the traversal's flags alone, and no launch."""
    sd = _sphere_free(dev)
    tables = tr.PacketTables(sd.bvh)
    rng = np.random.default_rng(9)
    o, d = _rays(rng, 4096, dev)
    occ, maxd, valid = _shadow_inputs(rng, 4096, dev)
    maxd = torch.clamp(torch.nan_to_num(maxd), min=0.0)
    before = (kspheres.launches_closest, kspheres.launches_any)
    t, ident = tr.sphere_pass(o, d, sd)
    assert bool((t == VERY_FAR).all()) and bool((ident == -1).all())
    shadow = dict(origin=o, direction=d, max_dist=maxd, valid=valid,
                  color=torch.ones_like(o))
    lit = tr._connect(sd, shadow, tables)
    masked = torch.where(valid, maxd, torch.zeros_like(maxd))
    occluded = tr.any_hit_packets(o, d, masked, tables)
    want = valid & ~occluded
    assert torch.equal((lit != 0).all(1), want)
    assert (kspheres.launches_closest, kspheres.launches_any) == before


def test_sphere_free_scene_skips_the_test_on_the_cpu():
    _sphere_free_check(torch.device("cpu"))


# --------------------------------------------------------------------------
# the card
# --------------------------------------------------------------------------

@pytest.mark.gpu
def test_sphere_free_scene_launches_nothing(cuda):
    _sphere_free_check(cuda)


def _ground_rays(rng, n: int, dev):
    """Rays starting on, just above and just below the top of the ground
    sphere (centre (0, 0, -10020), radius 1e4: the surface at z = -20
    under the scene), in every direction, grazing ones among them."""
    xy = rng.uniform(-300.0, 300.0, (n, 2))
    z = -1e4 - 20.0 + np.sqrt(1e8 - (xy ** 2).sum(1))
    z = z + rng.choice([0.0, 1e-3, -1e-3, 1e-2, 0.5, -0.5], n)
    o = np.concatenate([xy, z[:, None]], 1).astype(np.float32)
    d = rng.normal(size=(n, 3))
    d[: n // 2, 2] *= 1e-3  # grazing
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return torch.as_tensor(o, device=dev), torch.as_tensor(d, device=dev)


def _inside_rays(rng, n: int, c, r):
    """Rays starting inside the spheres (the far root)."""
    k = rng.integers(0, c.shape[0], n)
    cc, rr = c.cpu().numpy()[k], r.cpu().numpy()[k]
    off = rng.normal(size=(n, 3))
    off /= np.linalg.norm(off, axis=1, keepdims=True)
    o = cc + off * (rr * rng.uniform(0.0, 0.999, n))[:, None]
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return (torch.as_tensor(o.astype(np.float32), device=c.device),
            torch.as_tensor(d.astype(np.float32), device=c.device))


def _many_spheres(rng, s: int, dev):
    c = rng.uniform((-100, -100, 0), (100, 100, 150), (s, 3))
    r = rng.uniform(0.5, 12.0, s)
    return (torch.as_tensor(c.astype(np.float32), device=dev),
            torch.as_tensor(r.astype(np.float32), device=dev))


def _edge_case(name: str, dev):
    """(origin, direction, centers, radii) of the edge case ``name``."""
    rng = np.random.default_rng(100 + EDGE_CASES.index(name))
    c7, r7 = _seven(dev)
    n = 1 << 16
    if name == "ground":
        return (*_ground_rays(rng, n, dev), c7, r7)
    if name == "ties":
        # spheres 0 and 2, and 1 and 3, equal; rays aimed at them
        c = torch.stack([c7[0], c7[5], c7[0], c7[5], c7[4]])
        r = torch.stack([r7[0], r7[5], r7[0], r7[5], r7[4]])
        o, _ = _rays(rng, n, dev, lo=(-150, -150, 60), hi=(150, 150, 150))
        target = c[rng.integers(0, 2, n)] + torch.as_tensor(
            rng.normal(0.0, 8.0, (n, 3)).astype(np.float32), device=dev)
        d = torch.nn.functional.normalize(target - o, dim=1)
        return o, d.contiguous(), c.contiguous(), r.contiguous()
    if name == "inside":
        return (*_inside_rays(rng, n, c7, r7), c7, r7)
    if name == "one_sphere":
        return (*_rays(rng, n, dev), c7[4:5].contiguous(),
                r7[4:5].contiguous())
    if name == "past_one_tile":
        c, r = _many_spheres(rng, TILE + 44, dev)
        c[TILE + 20], r[TILE + 20] = c[3], r[3]  # a tie across the tiles
        o, _ = _rays(rng, n, dev)
        target = c[rng.choice([3, 10, TILE - 1, TILE, TILE + 43], n)]
        d = torch.nn.functional.normalize(target - o, dim=1)
        return o, d.contiguous(), c, r
    raise KeyError(name)


EDGE_CASES = ("ground", "ties", "inside", "one_sphere", "past_one_tile")


@pytest.mark.gpu
@pytest.mark.parametrize("name", EDGE_CASES)
def test_edge_cases_bit_for_bit(cuda, name):
    o, d, c, r = _edge_case(name, cuda)
    occ, maxd, valid = _shadow_inputs(np.random.default_rng(1), o.shape[0],
                                      cuda)
    got = compare(name, o, d, c, r, occ, maxd, valid)
    _assert_same(got)
    assert got["hits"] > 0 and got["sphere_occluded"] > 0, got
    if name == "ties":
        _, ident = kspheres.closest(o, d, c, r)
        assert set(torch.unique(ident).tolist()) <= {-1, 0, 1, 4}
    if name == "past_one_tile":
        _, ident = kspheres.closest(o, d, c, r)
        assert int((ident >= TILE).sum()) > 0
        assert int((ident == TILE + 20).sum()) == 0


def _config(name: str) -> dict:
    return json.loads((CONFIGS / f"{name}.json").read_text())


@pytest.fixture(scope="module")
def cells():
    """The benchmark's cells as eager Renderers, built on first use:
    perftest_1m and textured_1m by perfbench's own `build`, the preset
    on perftest_1m's scene and tables."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the sphere kernel has no CPU mode")
    from perfbench.run import build as build_cell
    from perfbench.run import run_seed
    eager = {"render": {"fuse_step_chains": "off"}}
    made = {}

    def get(name):
        if name not in made:
            if name == "preset_128k":
                base = get("perftest_1m")
                cfg = RenderConfig(**{**_config(name)["render"], **eager[
                    "render"]}, seed=run_seed(SEED))
                made[name] = tr.Renderer(base.scene, cfg, tables=base.tables)
            else:
                made[name] = build_cell(_config(name), SEED, "cuda",
                                        tiny=eager)[0]
        return made[name]
    yield get
    made.clear()
    torch.cuda.empty_cache()


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["perftest_1m", "textured_1m",
                                  "preset_128k"])
def test_cell_queues_bit_for_bit(cuda, cells, cell):
    """Each pose's extend queue after three steps there, and the shadow
    queue shade makes from its hits with the traversal's flags."""
    ren = cells(cell)
    cfg, sc = ren.cfg, ren.scene
    c, r = sc.sphere_center, sc.sphere_radius
    normals = tr.kernel_normals(cfg, sc)
    for pose in range(3):
        cam = camera_for_pose(pose)
        ren.step(cam, 3)
        st = ren.state
        rays = tr.merge_queue(cfg, st, cam.to_device(cfg, cuda))
        o, d = rays["origin"], rays["direction"]
        t, ident, is_tri, *tn = tr._intersect_scene(o, d, sc, ren.tables,
                                                    normals=normals)
        _, _, _, shadow = tr._shade(
            cfg, sc, ren.sky_params, ren.sun_dir, rays, t, ident, is_tri,
            tr._salted_frame(cfg, st.frame),
            tri_normal=tn[0] if normals else None)
        valid, md = shadow["valid"], shadow["max_dist"]
        so, sd = shadow["origin"], shadow["direction"]
        occ = tr.any_hit_packets(
            so, sd, torch.where(valid, md, torch.zeros_like(md)), ren.tables)
        # the extend queue's closest hit, then the shadow queue's any hit
        # (the closest hit of the shadow rays is checked too)
        for what, (qo, qd) in (("extend", (o, d)), ("shadow", (so, sd))):
            got = compare(f"{cell} pose {pose} {what} queue "
                          f"({int(st.n_carried)} carried)", qo, qd, c, r,
                          occ, md, valid)
            _assert_same(got)
            assert got["rays"] == cfg.num_rays and got["hits"] > 0, got


@pytest.mark.gpu
def test_captured_steps_launch_both_modes(cuda):
    """Captured render steps on the small terrain with the seven spheres:
    every replay launches both modes (the wrapper's counters by the
    renderer's replay counts), an eager step one launch of each, and with
    the tracer on each step counts two queues of ``sphere_kernel``."""
    sd = Scene.from_triangles(*terrain(n_quads=32, towers=3),
                              builder="numpy").to_device(cuda)
    cfg = small_config(64, 48, num_rays=4096, seed=SEED % 2 ** 31)
    profiling.enable()
    ren = tr.Renderer(sd, cfg)
    assert ren.captured
    cam = camera_for_pose(0)
    ren.step(cam, 6)
    torch.cuda.synchronize()
    replayed = ren.replayed_launches
    assert replayed.get("spheres_closest", 0) == ren.replayed_steps > 0
    assert replayed.get("spheres_any", 0) == ren.replayed_steps
    steps = profiling.snapshot()["steps"]
    assert len(steps) == 6
    assert all(s["counts"]["sphere_kernel"] == 2 * cfg.num_rays
               for s in steps), [s["counts"] for s in steps]

    eager = tr.Renderer(sd, small_config(64, 48, num_rays=4096, seed=7,
                                         fuse_step_chains="off"))
    before = (kspheres.launches_closest, kspheres.launches_any)
    eager.step(cam, 2)
    assert (kspheres.launches_closest, kspheres.launches_any) \
        == (before[0] + 2, before[1] + 2)


@pytest.mark.gpu
def test_chip_smoke_spheres_at_slice(cuda):
    """chip_smoke's sphere check at a small size: a carried queue, no
    mismatch in either mode, and the kernel, the plain chain and the
    bound timed."""
    import chip_smoke
    sd = Scene.from_triangles(*terrain(n_quads=32, towers=3),
                              builder="numpy").to_device(cuda)
    cfg = small_config(64, 48, num_rays=4096, seed=7, fuse_step_chains="off")
    out = chip_smoke.spheres_at_slice(tr.Renderer(sd, cfg), reps=2)
    assert out["rays"] == cfg.num_rays and out["carried"] > 0
    for mode in ("closest", "any"):
        e = out[mode]
        assert e["ms"] > 0 and e["plain_ms"] > 0 and e["bound_ms"] > 0
        assert e["library_ms"] is None
    assert out["closest"]["t_mismatches"] == out["closest"][
        "id_mismatches"] == out["any"]["mismatches"] == 0
