"""The CUDA kernels against their plain PyTorch versions, on the card.

These run chip_smoke.py's checks (phases 1, 2 and 4, the kernels at the
main path's queues, the denoised display path eager and captured, the
stream kernel's overflow, the equivalence gate, the pose harness, the
loaded scene, the sphere-free scene, the captured step against the eager
one, the normals output of both traversal kernels, the interactive
fly-through, the lights path, the textures path, the fog path, the
sampling path, with the fused moment2 mode of the accumulation, the
strips and the CLI) at small sizes, so the
card's checks live in one place.  The kernels have no CPU mode, so
these tests skip without a CUDA device.  This file imports no JAX, so it
also runs where JAX is not installed:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

import bench_torch
import chip_smoke
from tyrant_tpu_torch import render as tr
from tyrant_tpu_torch.config import small_config
from tyrant_tpu_torch.ops import stream as plain_stream
from tyrant_tpu_torch.ops import traverse as plain_trav
from tyrant_tpu_torch.ops.kernels import accum as kacc
from tyrant_tpu_torch.ops.kernels import spheres as kspheres
from tyrant_tpu_torch.ops.kernels import stream as kstream
from tyrant_tpu_torch.ops.kernels import traverse as ktrav
from tyrant_tpu_torch.scene.procgen import terrain
from tyrant_tpu_torch.scene.scene import Scene

from . import accum_cases

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def test_traverse_kernel_matches_plain(cuda):
    sd = Scene.from_triangles(*terrain(n_quads=32, towers=3),
                              builder="numpy").to_device(cuda)
    before = ktrav.launches, ktrav.launches_wave
    out = chip_smoke.phase1(sd, ktrav.PacketTables(sd.bvh), n_rays=4096)
    for gen in ("mono", "wave"):
        assert out[gen]["closest"]["hits"] > 0.2 * out[gen]["closest"]["rays"]
        assert out[gen]["any"]["occluded"] > 0
    assert (ktrav.launches, ktrav.launches_wave) == (before[0] + 2,
                                                     before[1] + 2)


def test_dead_and_ragged_shadow_queues(cuda):
    """Any-hit queues the live-slot compaction has to get right: nine slots
    in ten dead (max distance 0, or at most 2 EPSILON) with a length that is
    no multiple of a warp or of a block's tile, and a queue with no live
    slot at all, through both kernels against the plain walk."""
    sd = Scene.from_triangles(*terrain(n_quads=32, towers=3),
                              builder="numpy").to_device(cuda)
    tables = ktrav.PacketTables(sd.bvh)
    n = 5 * 2048 + 778
    assert n % 32 and n % 256
    o, d, span = chip_smoke.bench_rays(sd.bvh, n)
    r = np.random.default_rng(5)
    maxd = np.where(r.random(n) < 0.1, span, 0.0).astype(np.float32)
    maxd[r.random(n) < 0.05] = 1.5e-3  # under 2 EPSILON: dead as well
    maxd = torch.from_numpy(maxd).to(cuda)
    occ_p = plain_trav.any_hit(o, d, maxd, sd.bvh, active=maxd > 2e-3)
    assert 0 < int(occ_p.sum()) < int((maxd > 2e-3).sum()) < 0.15 * n
    for gen, wave in chip_smoke.GENERATIONS:
        before = ktrav.launches + ktrav.launches_wave
        occ_k = ktrav.any_hit_packets(o, d, maxd, tables, wave=wave)
        chip_smoke.check_any(f"ragged shadow queue {gen}", occ_k, occ_p)
        dead = ktrav.any_hit_packets(o, d, torch.zeros_like(maxd), tables,
                                     wave=wave)
        assert not bool(dead.any())
        assert ktrav.launches + ktrav.launches_wave == before + 2


def _max_stack(rows: np.ndarray, o: np.ndarray, d: np.ndarray) -> int:
    """The most row-stack entries the depth-first walk of one ray that hits
    no triangle holds (near child first, far child waiting)."""
    with np.errstate(divide="ignore"):
        inv = 1.0 / d.astype(np.float64)
    neg = d < 0
    stack, most = [0], 1
    while stack:
        row = rows[stack.pop()]
        push = []
        for base, tag, ref in ((0, ktrav._L_TAG, ktrav._L_REF),
                               (6, ktrav._R_TAG, ktrav._R_REF)):
            lo, hi = row[base:base + 3], row[base + 3:base + 6]
            t0 = ((np.where(neg, hi, lo) - o) * inv).max()
            t1 = ((np.where(neg, lo, hi) - o) * inv).min()
            push.append(bool(t0 <= t1 and t1 > 0) and row[tag] < 0
                        and int(row[ref]))
        near_is_r = bool(neg[int(row[ktrav._AXIS])])
        far, near = (push[0], push[1]) if near_is_r else (push[1], push[0])
        stack += [x for x in (far, near) if x]
        most = max(most, len(stack))
    return most


def _strip(cuda, n_tri: int = 16_384, k: int = 96):
    """A strip of ``n_tri`` slanted triangles along x, ``k`` rays that run
    its whole length inside every box (half each way, no hit) and 4k rays
    that come down onto it: (scene, tables, origin, direction, k)."""
    x = np.arange(n_tri, dtype=np.float32)
    v0 = np.stack([x, 0 * x, 0 * x], 1)
    v1 = v0 + np.float32([1, 0, 0])
    v2 = v0 + np.float32([0, 1, 1])  # in the plane y = z
    sd = Scene.from_triangles(v0, v1, v2, builder="numpy").to_device(cuda)
    tables = ktrav.PacketTables(sd.bvh)
    r = np.random.default_rng(9)
    # along the strip, off the plane y = z: through every box, no hit
    o = np.stack([np.full(k, -1.0), r.uniform(0.6, 0.95, k),
                  r.uniform(0.05, 0.4, k)], 1).astype(np.float32)
    d = np.tile(np.float32([1, 0, 0]), (k, 1))
    d[k // 2:] = [-1, 0, 0]
    o[k // 2:, 0] = n_tri + 1.0
    oh = np.stack([r.uniform(0, n_tri, 4 * k), r.uniform(0.1, 0.9, 4 * k),
                   np.full(4 * k, 5.0)], 1).astype(np.float32)
    dh = np.tile(np.float32([0, 0, -1]), (4 * k, 1))
    o_t = torch.from_numpy(np.concatenate([o, oh])).to(cuda)
    d_t = torch.from_numpy(np.concatenate([d, dh])).to(cuda)
    return sd, tables, o_t, d_t, k


def test_deep_walk_stacks_a_row_a_level(cuda):
    """A strip of 16,384 slanted triangles along x and rays that run its
    whole length inside every box: the far children wait on the stack level
    after level (more than 8 rows deep) through some 5,000 visits a ray.
    Both kernels against the plain walk, on those rays and on rays that hit
    the strip."""
    sd, tables, o_t, d_t, k = _strip(cuda)
    o, d = o_t[:k].cpu().numpy(), d_t[:k].cpu().numpy()
    assert _max_stack(tables.rows.numpy(), o[0], d[0]) > 8
    assert _max_stack(tables.rows.numpy(), o[-1], d[-1]) > 8
    t_p, id_p = plain_trav.closest_hit(o_t, d_t, sd.bvh)
    assert not bool((id_p[:k] >= 0).any()) and bool((id_p[k:] >= 0).any())
    maxd = torch.full((o_t.shape[0],), 2.0 * 16_384, device=cuda)
    occ_p = plain_trav.any_hit(o_t, d_t, maxd, sd.bvh)
    for gen, wave in chip_smoke.GENERATIONS:
        t_k, id_k = ktrav.closest_hit_packets(o_t, d_t, tables, wave=wave)
        res = chip_smoke.check_closest(f"deep strip {gen}", t_k, id_k, t_p,
                                       id_p)
        assert res["mismatches"] == 0
        chip_smoke.check_any(
            f"deep strip {gen} any hit",
            ktrav.any_hit_packets(o_t, d_t, maxd, tables, wave=wave), occ_p)


def test_accum_kernel_matches_plain(cuda):
    before = kacc.launches
    chip_smoke.phase2(5 * 2048 + 17, 8 * 1024)
    assert kacc.launches > before


@pytest.mark.parametrize("name", list(accum_cases.CASES))
def test_accum_edge_cases_through_both_wrappers(cuda, name):
    """The run-head kernel on its edge cases, through accumulate_terminated
    and accumulate_sorted, bit for bit the plain version on the CPU."""
    accum, key, pend = (torch.from_numpy(x) for x in
                        accum_cases.make_case(name, seed=11))
    p = accum.shape[0]
    upd_pix, upd_vals = kacc.terminated_updates(key, pend, p)
    want = kacc.accumulate_plain(accum.clone(), upd_pix, upd_vals)
    before = kacc.launches
    got_t = kacc.accumulate_terminated(accum.to(cuda), key.to(cuda),
                                       pend.to(cuda)).cpu()
    got_s = kacc.accumulate_sorted(accum.to(cuda), upd_pix.to(cuda),
                                   upd_vals.to(cuda)).cpu()
    torch.cuda.synchronize()
    assert kacc.launches == before + 2
    assert chip_smoke.same_bits(got_t, want)
    assert chip_smoke.same_bits(got_s, want)


def test_stream_on_records_matches_plain(cuda):
    """The stream kernel reads the node and triangle records, not the fat
    rows (which stay on the host): bit for bit in t, equal ids and equal
    pairs a level against the plain version on the fat rows, on a terrain
    and on the strip's deep walk; cap_mult=1 still raises."""
    sd = Scene.from_triangles(*terrain(n_quads=32, towers=3),
                              builder="numpy").to_device(cuda)
    terrain_tables = ktrav.PacketTables(sd.bvh)
    o, d, _ = chip_smoke.bench_rays(sd.bvh, 3000)
    _, strip_tables, so, sdir, _ = _strip(cuda, k=32)
    for tables, o_, d_ in ((terrain_tables, o, d),
                           (strip_tables, so, sdir)):
        assert tables.rows.device.type == "cpu"
        assert tables.nodes.is_cuda and tables.tris.is_cuda
        stats_p = {}
        n = o_.shape[0]
        t_p, id_p, ovf = plain_stream.closest_hit_stream(
            o_, d_, tables.rows.to(cuda), tables.max_depth,
            cap_mult=1000, stats=stats_p)
        assert int(ovf) == 0
        cap_mult = -(-max(stats_p["pairs"]) // n) + 1
        stats_k = {}
        t_k, id_k = kstream.closest_hit_stream(o_, d_, tables,
                                               cap_mult=cap_mult,
                                               stats=stats_k)
        assert stats_k["pairs"] == stats_p["pairs"]
        assert torch.equal(id_k, id_p)
        assert chip_smoke.same_bits(t_k, t_p)
        assert int((id_k >= 0).sum()) > 0
    assert len(stats_p["pairs"]) > 10  # the strip's walk is deep
    with pytest.raises(RuntimeError, match="frontier overflow"):
        kstream.closest_hit_stream(o, d, terrain_tables, cap_mult=1)


def test_render_on_card_matches_cpu(cuda):
    assert chip_smoke.phase4() < 0.03


def test_wave_phases_at_small_size(cuda):
    """The wave kernel against the plain walk on the main path's queues
    (extend, connect, AOV primaries), the denoised display path through
    it, and its display image on the card against the CPU."""
    cfg = small_config(width=96, height=64, num_rays=8192)
    ren = tr.Renderer(Scene.from_triangles(*terrain(n_quads=32, towers=3)),
                      cfg)
    queues = chip_smoke.kernels_at_slice(ren)
    for q in ("extend", "connect", "aov"):
        assert queues[q]["wave"]["mismatches"] == 0
        assert queues[q]["bound_ms"] > 0
    for q in ("extend", "aov"):
        assert queues[q]["stream"]["mismatches"] == 0
        assert queues[q]["stream"]["launches_per_call"] == ren.tables.max_depth
    disp = chip_smoke.display_path(
        ren.scene, ren.tables,
        small_config(width=96, height=64, num_rays=8192, denoise="on",
                     bloom_strength=0.1, packet_kernel_mode="wave"), steps=3)
    assert disp["launches"]["traverse_wave"] == 2 * 3 + 1
    assert chip_smoke.phase4(denoise_wave=True) < 0.03


def test_stream_gate_and_harness_at_small_size(cuda):
    """The stream kernel against its plain version (bit for bit) and the
    walk, its overflow at cap_mult=1, the equivalence gate with all three
    traversal kernels, and the pose harness over the three poses."""
    sd = Scene.from_triangles(*terrain(n_quads=32, towers=3),
                              builder="numpy").to_device(cuda)
    tables = ktrav.PacketTables(sd.bvh)
    before = kstream.launches
    out = chip_smoke.phase1(sd, tables, n_rays=4096)
    assert out["stream"]["closest"]["mismatches"] == 0
    assert out["stream"]["overflow"]["flag"] == 1
    assert kstream.launches > before
    eq = chip_smoke.gate(sd)
    assert eq["result"] == "ok" and eq["launches"]["stream"] == tables.max_depth
    bench, _ = bench_torch.bench_scene(
        sd, 0.2, cfg=small_config(width=96, height=64, num_rays=8192))
    assert [p["pose"] for p in bench["poses"]] == [0, 1, 2]


def test_loaded_scene_path_at_small_size(cuda):
    """chip_smoke's loaded scene (a PLY terrain with vertex normals and
    instances of the OBJ/MTL asset as GGX, IOR-1.7 glass and frosted glass,
    from a JSON description, dispersion 0.02) at a small size: both
    traversal kernels against the plain walk on its extend, shadow and AOV
    queues, the accumulation on its step's queue, launches counted."""
    cfg = small_config(width=96, height=64, num_rays=8192)
    ld = chip_smoke.loaded_path(cfg, n_tris=20_000)
    assert all(ld["flags"][k] for k in ("has_ggx", "has_rrefr",
                                        "has_var_ior", "smooth_normals"))
    for q in ("extend", "connect", "aov"):
        for gen in ("mono", "wave"):
            assert ld["queues"][q][gen]["mismatches"] == 0
    assert ld["launches"]["mono"]["traverse"] == 28
    assert ld["launches"]["wave"]["traverse_wave"] == 28
    assert ld["queues"]["accumulate"]["max_abs_err"] == 0.0


def test_sphere_free_path_at_small_size(cuda):
    """chip_smoke's sphere-free glTF scene at a small size: every extend
    ray seeded with VERY_FAR, both kernels against the plain walk, no hit
    with a sphere id, the accumulation on its step's queue."""
    cfg = small_config(width=96, height=64, num_rays=8192)
    sf = chip_smoke.sphere_free_path(cfg, n_tris=8_000)
    assert sf["queues"]["extend"]["t_init_all_far"]
    for q in ("extend", "connect", "aov"):
        for gen in ("mono", "wave"):
            assert sf["queues"][q][gen]["mismatches"] == 0
    assert sf["launches"]["traverse"] == 28
    assert sf["queues"]["accumulate"]["max_abs_err"] == 0.0


@pytest.mark.parametrize("n_tris", [1, 5])
@pytest.mark.parametrize("spheres", ["seven", "none"])
def test_root_leaf_scene(cuda, n_tris, spheres):
    """A mesh whose BVH root is a leaf (the single-row pseudo-root of
    ops/kernels/traverse.py), with and without spheres: both traversal
    kernels and the stream kernel against the plain walk on the extend,
    shadow and AOV queues, and a render whose paths all end counted."""
    from tyrant_tpu_torch.scene.scene import Spheres
    k = np.arange(n_tris, dtype=np.float32)[:, None]
    # up-facing triangles in pose 0's view, each above the one before
    v0 = np.float32([-30, 0, 0]) + k * np.float32([12, 6, 2])
    v1 = v0 + np.float32([60, 0, 0])
    v2 = v0 + np.float32([0, 60, 5])
    sp = None
    if spheres == "none":
        e = np.zeros((0, 3), np.float32)
        sp = Spheres(center=e, radius=np.zeros(0, np.float32), color=e,
                     emission=e, refl=np.zeros(0, np.int32))
    cfg = small_config(width=64, height=48, num_rays=4096)
    ren = tr.Renderer(Scene.from_triangles(v0, v1, v2, spheres=sp,
                                           builder="numpy"), cfg)
    assert ren.tables.rows.shape[0] == 1
    queues = chip_smoke.kernels_at_slice(ren)
    for q in ("extend", "connect", "aov"):
        for gen in ("mono", "wave"):
            assert queues[q][gen]["mismatches"] == 0
    assert queues["extend"]["mono"]["hits"] > 0
    assert queues["extend"]["t_init_all_far"] == (spheres == "none")
    acc = ren.state.accum
    assert bool(torch.isfinite(acc).all()) and float(acc[:, 3].sum()) > 0


def test_captured_step_is_bit_equal_to_eager(cuda):
    """chip_smoke's captured main cell at a small size: the captured step
    bit for bit the eager one on every RenderState field after 6 steps
    with a pose and a sun change between, then phase 3 captured (14 steps
    a pose, all replayed) and a chain of four timed."""
    sd = Scene.from_triangles(*terrain(n_quads=32, towers=3)).to_device(cuda)
    tables = ktrav.PacketTables(sd.bvh)
    cap = chip_smoke.captured_step(sd, tables,
                                   small_config(96, 64, num_rays=8192),
                                   poses_run=(0, 1))
    assert cap["equal_after_6"]
    assert cap["launches"] == {"traverse": 2 * 28, "traverse_wave": 0,
                               "accumulate": 28, "stream": 0, "shade": 28,
                               "spheres_closest": 28, "spheres_any": 28}
    assert all(p["device_busy_ms_per_step"] > 0 for p in cap["poses"])
    assert set(cap["chain_ms_per_step"]) == {"1", "4"}


def test_captured_replays_count_launches(cuda):
    """A replay adds nothing to the wrappers' counters; the renderer
    counts the replayed steps and their launches, one graph of one step
    and one of the AOV pass, replayed once per pose."""
    sd = Scene.from_triangles(*terrain(n_quads=16, towers=2)).to_device(cuda)
    ren = tr.Renderer(sd, small_config(64, 48, num_rays=4096,
                                       denoise="on"))
    chip_smoke.reset_launches(ren)
    ren.step(chip_smoke.camera_for_pose(0), 10)
    assert ren.replayed_steps == 9
    assert (kacc.launches, ktrav.launches) == (1, 2)  # the warm-up
    assert (kspheres.launches_closest, kspheres.launches_any) == (1, 1)
    assert ren.replayed_launches == {"traverse": 18, "accumulate": 9,
                                     "shade": 9, "spheres_closest": 9,
                                     "spheres_any": 9}
    ren.image()
    ren.image()  # the same pose: the AOV pass is not run again
    assert ktrav.launches == 3  # its warm-up
    assert kspheres.launches_closest == 2
    assert ren.replayed_launches["traverse"] == 19
    assert ren.replayed_launches["spheres_closest"] == 10
    assert set(ren._graphs) == {"step", "aov", ("image", True, False)}


def test_captured_image_is_bit_equal_to_eager(cuda):
    """chip_smoke's display path at a small size: image() with the
    denoiser and bloom, and image(uint8=True), captured, bit for bit the
    eager ones."""
    sd = Scene.from_triangles(*terrain(n_quads=32, towers=3)).to_device(cuda)
    disp = chip_smoke.display_path(
        sd, ktrav.PacketTables(sd.bvh),
        small_config(width=96, height=64, num_rays=8192, denoise="on",
                     bloom_strength=0.1, packet_kernel_mode="wave"), steps=3)
    assert disp["captured"]["image_equal"]
    assert disp["captured"]["launches"]["accumulate"] == 3


@pytest.mark.parametrize("wave", [False, True])
def test_kernel_normals_match_plain(cuda, wave):
    """Both kernels' normals output bit for bit the plain version's
    arithmetic on their own ids, their t and ids those of the kernel
    without normals, zero on a miss; any hit takes no normals."""
    sd = Scene.from_triangles(*terrain(n_quads=32, towers=3),
                              builder="numpy").to_device(cuda)
    tables = ktrav.PacketTables(sd.bvh)
    o, d, _ = chip_smoke.bench_rays(sd.bvh, 4096)
    t0, id0 = ktrav.closest_hit_packets(o, d, tables, wave=wave)
    before = ktrav.launches_wave_normals if wave else ktrav.launches_normals
    t1, id1, n1 = ktrav.closest_hit_packets(o, d, tables, wave=wave,
                                            normals=True)
    after = ktrav.launches_wave_normals if wave else ktrav.launches_normals
    assert after == before + 1
    assert torch.equal(id0, id1) and chip_smoke.same_bits(t0, t1)
    assert chip_smoke.same_bits(n1, plain_trav.hit_normals(sd.bvh.tri_packed,
                                                           id1))
    assert bool((n1[id1 < 0] == 0).all()) and int((id1 >= 0).sum()) > 0
    t_p, id_p, n_p = plain_trav.closest_hit(o, d, sd.bvh, normals=True)
    agree = id1 == id_p
    assert chip_smoke.same_bits(n1[agree], n_p[agree])


def test_normals_at_the_preset_extend_queue(cuda):
    """chip_smoke's normals check on the interactive preset's extend queue
    at a small size."""
    from tyrant_tpu_torch.config import interactive_config
    sd = Scene.from_triangles(*terrain(n_quads=32, towers=3)).to_device(cuda)
    ren = tr.Renderer(sd, interactive_config(96, 64, num_rays=8192,
                                             fuse_step_chains="off"))
    out = chip_smoke.normals_at_extend(ren)
    assert out["hits"] > 0
    for gen in ("mono", "wave"):
        assert out[gen]["mismatches"] == 0
        assert out[gen]["normals_max_abs_err"] == 0.0


def test_small_flythrough(cuda):
    """chip_smoke's fly-through at a small size: the preset with normals
    and capture each on and off and the wave kernel, launches and replays
    counted."""
    from tyrant_tpu_torch.config import interactive_config
    sd = Scene.from_triangles(*terrain(n_quads=32, towers=3)).to_device(cuda)
    assert sd.tri_default_mat
    fly = chip_smoke.flythrough(sd, ktrav.PacketTables(sd.bvh),
                                interactive_config(96, 64, num_rays=8192),
                                n_frames=4, profiled=2)
    steps = 2 * (2 + 4) + 2
    on = fly["normals-on-auto"]
    assert on["captured"] and on["replayed_steps"] == steps - 1
    assert on["launches"]["traverse_normals"] == steps
    assert fly["normals-off-off"]["launches"]["traverse_normals"] == 0
    assert fly["normals-on-wave-auto"]["launches"][
        "traverse_wave_normals"] == steps
    for run in ("normals-on-off", "normals-off-off"):
        assert fly[run]["eager_split"]["ops"]["shade"] > 0


def test_failed_capture_raises(cuda, monkeypatch):
    """A step that cannot be captured (here one that reads a value back to
    the host) raises, and the renderer does not go on eagerly."""
    sd = Scene.from_triangles(*terrain(n_quads=16, towers=2)).to_device(cuda)
    ren = tr.Renderer(sd, small_config(64, 48, num_rays=4096,
                                       fuse_step_chains="on"))
    step = tr.render_step

    def syncing_step(state, *args, **kw):
        float(state.n_carried)  # a host read: no graph can hold it
        return step(state, *args, **kw)

    monkeypatch.setattr(tr, "render_step", syncing_step)
    with pytest.raises(RuntimeError, match="capturing the render step"):
        ren.step(chip_smoke.camera_for_pose(0), 2)
    assert ("step", 1) not in ren._graphs and ren.replayed_steps == 0


SMALL_LIGHTS = {"many": dict(chip_smoke.LIGHT_CASES["many"], n_tri=96,
                             envmap=(64, 128)),
                "few": dict(chip_smoke.LIGHT_CASES["few"], n_tri=8)}


def test_lights_path_at_small_size(cuda):
    """chip_smoke's lights path at a small size, both configurations:
    both traversal kernels against the plain walk on its extend, shadow
    (finite, shrunk ranges toward emissive triangles in the BVH) and AOV
    queues, the accumulation on its step's queue, launches counted eager,
    captured and with the wave kernel, the card against the CPU."""
    cfg = small_config(width=96, height=64, num_rays=8192)
    host = Scene.from_triangles(*terrain(n_quads=32, towers=3))
    lt = chip_smoke.lights_path(host, cfg, SMALL_LIGHTS)
    for case in ("many", "few"):
        out = lt[case]
        for q in ("extend", "connect", "aov"):
            for gen in ("mono", "wave"):
                assert out["queues"][q][gen]["mismatches"] == 0
        assert out["queues"]["accumulate"]["max_abs_err"] == 0.0
        assert out["launches"]["eager"]["traverse"] == 2 * 42
        assert out["launches"]["captured"]["traverse"] == 2 * 42
        assert out["launches"]["wave"]["traverse_wave"] == 2 * 14
        assert out["queues"]["connect"]["targets"]["finite"] > 0
        assert out["card_vs_cpu"] < 0.03
    assert lt["many"]["counts"]["pick"] == "alias"
    assert lt["few"]["counts"]["pick"] == "cdf"


@pytest.mark.parametrize("case", ["many", "few"])
def test_captured_lights_step_is_bit_equal_to_eager(cuda, case, tmp_path):
    """The lights scenes' step captured (with MIS, the carried pdfs in the
    graph's static buffers) bit for bit the eager step after 6 steps with
    a pose and a sun change between; the static pdf buffer is [N] with
    MIS and [1] without."""
    import dataclasses
    host = Scene.from_triangles(*terrain(n_quads=32, towers=3))
    sc, over, _ = chip_smoke.light_scene(host, case, tmp_path,
                                         SMALL_LIGHTS[case])
    cfg = small_config(96, 64, num_rays=8192, **over)
    sd = sc.to_device(cuda)
    cap = chip_smoke.captured_step(sd, ktrav.PacketTables(sd.bvh),
                                   dataclasses.replace(
                                       cfg, fuse_step_chains="auto"),
                                   poses_run=(0,), chain=False)
    assert cap["equal_after_6"]
    assert cap["launches"]["traverse"] == 2 * 14
    ren = tr.Renderer(sd, cfg)
    ren.step(chip_smoke.camera_for_pose(0), 2)
    assert ren.state.bsdf_pdf.shape == ((8192,) if case == "many" else (1,))


SMALL_TEX = dict(n_tris=20_000, n_leaves=2048, n_blend=256, poses_run=(0,),
                 texture_px=dict(albedo_px=128, normal_px=128, rough_px=64,
                                 leaf_px=64),
                 small=dict(n_quads=24, n_leaves=512, n_blend=64))


def test_textures_path_at_small_size(cuda):
    """chip_smoke's textures path at a small size: the textured scene's
    step captured bit for bit the eager one, phase 3 under every filter
    and the wave kernel, both traversal kernels against the plain walk on
    its extend, shadow and AOV queues, the accumulation on its step's
    queue, the textured shade kernels against the plain body under
    "bilinear" and "nearest" (one launch of each kernel a step), image()
    with the denoiser, the card against the CPU."""
    cfg = small_config(width=96, height=64, num_rays=8192)
    tx = chip_smoke.textures_path(cfg, **SMALL_TEX)
    for q in ("extend", "connect", "aov"):
        for gen in ("mono", "wave"):
            assert tx["queues"][q][gen]["mismatches"] == 0
    assert tx["queues"]["accumulate"]["max_abs_err"] == 0.0
    assert tx["launches"]["eager"]["traverse"] == 2 * 14
    assert tx["launches"]["captured"]["traverse"] == 2 * 14
    assert tx["launches"]["wave"]["traverse_wave"] == 2 * 14
    for filt in ("bilinear", "nearest"):
        at = tx["at_step"][filt]
        assert not any(at["mismatches"].values()), at["mismatches"]
        assert at["filter"] == filt and at["taps"] > 0
    for run in ("eager", "captured", "wave"):
        assert tx["launches"][run]["shade_surface"] == 14
        assert tx["launches"][run]["shade_textured"] == 14
    assert tx["card_vs_cpu"] < 0.03


def test_fog_path_at_small_size(cuda):
    """chip_smoke's fog path at a small size: the fog step captured bit
    for bit the eager one, the kernels on its queues (the shadow queue
    with fog's transmittance), the lights "few" with MIS under fog, the
    card against the CPU."""
    cfg = small_config(width=96, height=64, num_rays=8192)
    host = Scene.from_triangles(*terrain(n_quads=32, towers=3))
    fg = chip_smoke.fog_path(host, cfg, poses_run=(0,),
                             light_spec=SMALL_LIGHTS["few"])
    for q in ("extend", "connect", "aov"):
        for gen in ("mono", "wave"):
            assert fg["queues"][q][gen]["mismatches"] == 0
    assert fg["queues"]["accumulate"]["max_abs_err"] == 0.0
    assert fg["launches"]["captured"]["traverse"] == 2 * 14
    assert fg["launches"]["lights"]["accumulate"] == 14
    assert fg["card_vs_cpu"] < 0.03


@pytest.mark.parametrize("over", [dict(texture_filter="nearest"),
                                  dict(texture_filter="trilinear"),
                                  dict(chip_smoke.FOG, fog_z_min=-100.0,
                                       fog_z_max=60.0, mis="on")])
def test_captured_textured_and_fog_steps_bit_equal(cuda, over):
    """The textured step under "nearest" and "trilinear" (the mip
    footprint's select chains in the graph) and the fog step with MIS,
    captured, bit for bit the eager step after 6 steps with a pose and a
    sun change between."""
    import dataclasses

    from tyrant_tpu_torch.scene import files
    kw = files.textured_scene(*terrain(n_quads=32, towers=3), n_leaves=1024,
                              n_blend=128, albedo_px=64, normal_px=64,
                              rough_px=32, leaf_px=32)
    sd = Scene.from_triangles(**kw).to_device(cuda)
    cfg = small_config(96, 64, num_rays=8192, **over)
    cap = chip_smoke.captured_step(sd, ktrav.PacketTables(sd.bvh),
                                   dataclasses.replace(
                                       cfg, fuse_step_chains="auto"),
                                   poses_run=(0,), chain=False)
    assert cap["equal_after_6"]
    assert cap["launches"]["traverse"] == 2 * 14


@pytest.mark.parametrize("name", list(accum_cases.CASES))
def test_moment2_mode_matches_plain(cuda, name):
    """The fused moment2 mode (accum_kernel<3,true>) on the run-head edge
    cases: accum and moment2 bit for bit the plain version's two
    accumulate_plain calls on the CPU, one launch counted as a moment2
    launch."""
    accum, key, pend = (torch.from_numpy(x) for x in
                        accum_cases.make_case(name, seed=12))
    moment2 = torch.from_numpy(np.abs(accum_cases.make_case(name,
                                                            seed=13)[0]))
    p = accum.shape[0]
    want_a = kacc.accumulate_plain(accum.clone(),
                                   *kacc.terminated_updates(key, pend, p))
    want_m = kacc.accumulate_plain(moment2.clone(),
                                   *kacc.moment2_updates(key, pend, p))
    before = kacc.launches, kacc.launches_moment2
    m2 = moment2.to(cuda)
    got_a = kacc.accumulate_terminated(accum.to(cuda), key.to(cuda),
                                       pend.to(cuda), moment2=m2).cpu()
    torch.cuda.synchronize()
    assert (kacc.launches, kacc.launches_moment2) == (before[0],
                                                      before[1] + 1)
    assert chip_smoke.same_bits(got_a, want_a)
    assert chip_smoke.same_bits(m2.cpu(), want_m)


SMALL_MODES = {**{k: v for k, v in chip_smoke.CAMERA_MODES.items()
                  if k != "crop-clamp"},
               "crop-clamp": dict(crop=(24, 16, 48, 32), radiance_clamp=10.0)}


def test_sampling_path_at_small_size(cuda):
    """chip_smoke's sampling path at a small size: Sobol eager, captured
    (bit for bit the eager step) and wave, its pass counter, a checkpoint
    saved after 8 captured steps and resumed bit for bit, adaptive
    sampling with track_variance captured (4 rebuilds, the noise estimate
    falling, the fused moment2 mode bit for bit on its step's queue),
    motion blur on a small preset captured and eager, the camera modes;
    the kernels against the plain walk on every run's queues."""
    cfg = small_config(width=96, height=64, num_rays=8192)
    host = Scene.from_triangles(*terrain(n_quads=32, towers=3))
    smp = chip_smoke.sampling_path(
        host, cfg, poses_run=(0,),
        preset=small_config(width=96, height=64, num_rays=4096),
        fly_frames=4, modes=SMALL_MODES)
    for run, queues in smp["queues"].items():
        for q in ("extend", "connect", "aov"):
            for gen in ("mono", "wave"):
                assert queues[q][gen]["mismatches"] == 0, (run, q, gen)
    assert smp["moment2_step_queue"]["max_abs_err"] == 0.0
    assert smp["launches"]["adaptive"]["accumulate_moment2"] == 16
    assert smp["launches"]["sobol-captured"]["traverse"] == 2 * 14
    assert smp["adaptive"]["rebuilds"] == 4
    assert smp["checkpoint"]["captured"]  # resumed bit for bit, captured
    assert smp["card_vs_cpu"] < 0.03
    assert set(smp["modes"]) == set(SMALL_MODES)


@pytest.mark.parametrize("over", [
    dict(sampler="sobol", seed=7), dict(sampler="sobol", mis="on"),
    dict(adaptive_sampling="on", adaptive_interval=2, track_variance="on"),
    dict(motion_blur=0.5), dict(motion_blur=1.0, projection="ortho",
                                ortho_height=60.0, bokeh_blades=5),
    dict(projection="fisheye"), dict(projection="equirect"),
    dict(crop=(16, 8, 48, 40), radiance_clamp=2.0)])
def test_captured_step_bit_equal_under_new_fields(cuda, over):
    """The captured step bit for bit the eager one on every RenderState
    field after 6 steps with a pose and a sun change between, under each
    field of this slice (motion blur's previous-pose buffer and the
    adaptive rebuild between replays among them)."""
    import dataclasses
    sd = Scene.from_triangles(*terrain(n_quads=32, towers=3)).to_device(cuda)
    cfg = small_config(96, 64, num_rays=8192, **over)
    cap = chip_smoke.captured_step(sd, ktrav.PacketTables(sd.bvh),
                                   dataclasses.replace(
                                       cfg, fuse_step_chains="auto"),
                                   poses_run=(0,), chain=False)
    assert cap["equal_after_6"]
    assert cap["launches"]["traverse"] == 2 * 14


def test_strips_at_small_size(cuda):
    """chip_smoke.strips_path at 64x64 (two strips of 64x32): one strip
    bit for bit the eager Renderer, the two strips launching the traversal,
    accumulation and shade kernels every step, each of them in the step split by strip, the two against
    the CPU."""
    cfg = small_config(width=64, height=64, num_rays=1 << 14,
                       fuse_step_chains="off")
    sd = Scene.from_triangles(*terrain(n_quads=32, towers=3),
                              builder="numpy").to_device(cuda)
    out = chip_smoke.strips_path(sd, ktrav.PacketTables(sd.bvh), cfg, reps=3)
    assert out["one_strip_bit_for_bit"] and out["card_vs_cpu"] < 0.03
    assert out["two_launches"]["traverse"] == 12
    assert out["two_launches"]["accumulate"] == 6
    assert out["two_strip_launches"] == [{"traverse": 2, "accumulate": 1,
                                          "shade": 1, "spheres_closest": 1,
                                          "spheres_any": 1}] * 2


def test_strip_step_with_row_offset_on_the_card(cuda):
    """Rows 16-31 of a 32x32 frame stepped on the card (local_height 16,
    row_offset 16) and on the CPU from the same start: the frame counter
    exact, every pixel id local to the strip, the resolved strips within
    0.03 (the survivors, and so the scan position, follow the float
    arithmetic of each device)."""
    from tyrant_tpu_torch.ops.tonemap import resolve
    cfg = small_config(width=32, height=32, num_rays=1 << 12)
    sc = Scene.from_triangles(*terrain(n_quads=24, towers=2),
                              builder="numpy")
    out = []
    for dev in (cuda, torch.device("cpu")):
        sd = sc.to_device(dev)
        tables = ktrav.PacketTables(sd.bvh)
        st = tr.init_state(cfg, dev, local_height=16)
        cam = chip_smoke.camera_for_pose(0).to_device(cfg, dev)
        sun = tr.skymod.sun_direction_from_position((0.05, 0.3), dev)
        for _ in range(4):
            st = tr.render_step(st, sd, cam, sun, cfg=cfg, tables=tables,
                                local_height=16, row_offset=16)
        out.append(st)
    card, cpu = out
    assert card.accum.shape == (32 * 16, 4)
    assert int(card.frame) == int(cpu.frame) == 5
    assert 0 <= int(card.pixel.min()) and int(card.pixel.max()) < 32 * 16
    mad = (resolve(card.accum.cpu(), 32, 16)
           - resolve(cpu.accum, 32, 16)).abs().mean()
    assert float(mad) < 0.03, float(mad)


def test_cli_render_on_the_card(cuda, tmp_path):
    """``cli render`` on the card: its PNG, decoded with zlib, bit for bit
    the Renderer's image after the same steps; ``bvh-debug`` writes its
    heatmap."""
    from tyrant_tpu_torch import cli
    from tyrant_tpu_torch.config import RenderConfig
    out = tmp_path / "x.png"
    argv = ["--width", "64", "--height", "48", "--rays", "4096",
            *chip_smoke.pose_argv(0)]
    cli.main(["render", *argv, "--steps", "5", "--out", str(out)])
    r = tr.Renderer(Scene.load(None), RenderConfig(width=64, height=48,
                                                   num_rays=4096))
    r.step(chip_smoke.camera_for_pose(0), 5)
    assert np.array_equal(chip_smoke.png_pixels(out.read_bytes()),
                          r.image(uint8=True).cpu().numpy())
    cli.main(["bvh-debug", *argv, "--out", str(tmp_path / "h.png")])
    assert chip_smoke.png_pixels((tmp_path / "h.png").read_bytes()).shape \
        == (48, 64, 3)


def test_bench_scene_small_on_the_card(cuda, monkeypatch):
    """``bench_torch.bench_scene`` on the card at 64x48 and 4,096 rays:
    three poses with finite positive times, through the kernels; and the
    gate of ``--equivalence-only`` on a small scene."""
    sc = Scene.from_triangles(*terrain(n_quads=32, towers=3),
                              builder="numpy")
    chip_smoke.reset_launches()
    d, cfg = bench_torch.bench_scene(sc, 0.2, cfg=small_config(
        width=64, height=48, num_rays=4096))
    torch.cuda.synchronize()
    launches = chip_smoke.read_launches()
    assert cfg.num_rays == 4096 and [r["pose"] for r in d["poses"]] == \
        [0, 1, 2]
    assert all(np.isfinite(r["avg_ms"]) and r["avg_ms"] > 0
               and r["total_mrays_per_s"] > 0 for r in d["poses"])
    assert launches["traverse"] >= 2 and launches["accumulate"] >= 1
    monkeypatch.setattr(bench_torch, "DRAGON_TRIS", 8192)
    monkeypatch.setattr(bench_torch, "GATE_RAYS", 4096)
    assert bench_torch.equivalence_only() == "ok"


def test_instances_example_on_the_card(cuda, tmp_path):
    """``examples/render_instances_torch.py`` on the card at 64x48: its
    PNG decodes to the image it returns, and to the CPU's within a mean
    0.03 after the same steps."""
    from tyrant_tpu_torch.scene import files
    mesh = tmp_path / "terrain.ply"
    files.write_ply(mesh, *terrain(n_quads=24, towers=2))
    mod = chip_smoke.load_example("render_instances_torch")
    imgs = {}
    for dev in ("cuda", "cpu"):
        out = tmp_path / f"{dev}.png"
        imgs[dev] = mod.render(str(mesh), n=3, steps=4, width=64, height=48,
                               rays=4096, out=str(out), device=dev)
        assert np.array_equal(chip_smoke.png_pixels(out.read_bytes()),
                              imgs[dev])
    diff = np.abs(imgs["cuda"].astype(float) - imgs["cpu"]) / 255
    assert diff.mean() < 0.03
