"""The textured shade variant (``csrc/shade_textured.cu``: the surface
kernel, then the shade kernel from its record; ``ops/kernels/shade.py``'s
``surface`` and ``shade_textured``) against its plain version
(``render._shade_plain``) on the card, on the same inputs: a small scene
of the benchmark's textured generator (``perfbench/scenes/textured.py``
at the ``textured_1m`` configuration's settings, on a smaller terrain
with fewer leaves and more blend panes), under "nearest" and "bilinear",
row offsets 0 and 540, three frames each from a fresh queue on; then four
captured render steps through the variant against four with the plain
body captured, and ``chip_smoke.shade_at_step`` (the same check on the
``textured_1m`` queue at full size) at a small size.

The standard is ``tests/test_torch_shade_kernel.py``'s: the survive
flags, the shadow rays' valid flags, the sun-or-light pick, pixel,
bounces and last_specular equal; every float output within 1e-5 relative
on every slot the step reads (a miss's next origin and shadow ray are
not read: the plain body takes them from triangle 0's maps,
``chip_smoke.MISS_UNREAD``); the slots off counted by
what each shaded (``chip_smoke.TEXTURED_CATEGORIES``: a mapped DIFF
triangle, GGX, a cutout pass-through, a blend pane shaded or passed, a
sphere, a miss), every category with slots, and the atlas with each
wrap mode.  The tracer's ``tex_hits``, ``alpha_pass`` and ``ggx_hits``
from the variant equal the plain body's on the same inputs, and its
``shade_fused`` is the queue.  The kernels have no CPU mode, so these
tests skip without a CUDA device.  This file imports no JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_shade_textured.py -s
"""

import json
from pathlib import Path

import pytest
import torch

from perfbench.scenes import textured as generator
from tyrant_tpu_torch import render as tr
from tyrant_tpu_torch import sky as tsky
from tyrant_tpu_torch.bench.poses import camera_for_pose
from tyrant_tpu_torch.config import VERY_FAR, small_config
from tyrant_tpu_torch.ops.kernels import shade as kshade
from tyrant_tpu_torch.scene.scene import Scene
from tyrant_tpu_torch.utils import profiling

pytestmark = pytest.mark.gpu

CONFIG = Path(__file__).resolve().parents[1] / "perfbench" / "configs" \
    / "textured_1m.json"
# the configuration's generator settings (map sizes, seed, ground) on a
# 2,192-triangle terrain, with 4,096 leaves and 1,024 blend panes
SMALL = {"terrain": {"n_tris_target": 2048},
         "textured": {"n_leaves": 4096, "n_blend": 2048}}
SUN = (0.05, 0.3)
COUNTERS = ("tex_hits", "alpha_pass", "ggx_hits")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the shade kernels have no CPU mode")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def scene():
    conf = json.loads(CONFIG.read_text())["scene"]
    for group, over in SMALL.items():
        conf[group] = {**conf[group], **over}
    return Scene.from_triangles(**generator.make(conf), builder="numpy")


def _deferred() -> dict:
    """The tracer's deferred counters of the shade call just made."""
    d = profiling._tracer.deferred
    out = {k: int(fn()) for k, fn in d.items() if k in COUNTERS
           or k == "shade_fused"}
    d.clear()
    return out


@pytest.mark.parametrize("texture_filter", ["nearest", "bilinear"])
@pytest.mark.parametrize("row_offset", [0, 540])
def test_textured_kernels_match_plain(cuda, scene, texture_filter,
                                      row_offset):
    import chip_smoke
    sd = scene.to_device(cuda)
    cfg = small_config(width=32, height=1080, num_rays=8192, seed=1234567891,
                       texture_filter=texture_filter)
    assert kshade.variant(cfg, sd, cuda) == kshade.TEXTURED
    assert {w for m in sd.tex_meta for w in m[3:5]} == {0, 1, 2}
    tables = tr.PacketTables(sd.bvh)
    sky = tsky.SkyParams(cfg.sky)
    sun = tsky.sun_direction_from_position(SUN, cuda)
    cam = camera_for_pose(0).to_device(cfg, cuda)
    local = 540
    st = tr.init_state(cfg, cuda, local_height=local)
    before = (kshade.launches_surface, kshade.launches_textured)
    slots = dict.fromkeys(chip_smoke.TEXTURED_CATEGORIES, 0)
    profiling.enable()
    try:
        for frame in range(3):
            rays = tr.merge_queue(cfg, st, cam, local_height=local,
                                  row_offset=row_offset)
            t, ident, is_tri = tr._intersect_scene(
                rays["origin"], rays["direction"], sd, tables)
            fs = tr._salted_frame(cfg, st.frame)
            args = (cfg, sd, sky, sun, rays, t, ident, is_tri, fs, None,
                    row_offset)
            plain = tr._shade_plain(*args)
            want = _deferred()
            fused = tr._shade(*args)
            got_counts = _deferred()
            rec = kshade.surface(cfg, sd, rays, t, ident, is_tri, fs,
                                 None, row_offset)
            torch.cuda.synchronize()
            hit = t < VERY_FAR
            got, n_eq, n_el = chip_smoke.shade_mismatches(fused, plain,
                                                          hit_mask=hit)
            bad = torch.zeros_like(hit)
            for v in chip_smoke.shade_bad_slots(fused, plain,
                                                hit_mask=hit).values():
                bad |= v
            cats = chip_smoke.by_category(chip_smoke.textured_categories(
                sd, t, ident, is_tri, rec), bad)
            print(f"textured shade {texture_filter} row_offset {row_offset} "
                  f"frame {frame} carried {int(st.n_carried)}: mismatches "
                  f"{json.dumps(got)}; float elements bit for bit "
                  f"{n_eq}/{n_el}; (slots, slots off) by what they shaded "
                  f"{json.dumps(cats)}; counters {got_counts} (plain "
                  f"{want})")
            if frame:
                assert int(st.n_carried) > 0
            assert not any(got.values()), (got, cats)
            assert {k: got_counts[k] for k in COUNTERS} == want
            assert got_counts["shade_fused"] == cfg.num_rays
            for k, (n, _) in cats.items():
                slots[k] += n
            st = tr.render_step(st, sd, cam, sun, cfg=cfg, tables=tables,
                                sky_params=sky, local_height=local,
                                row_offset=row_offset)
    finally:
        profiling.disable()
    print(f"slots by what they shaded over the three frames: {slots}")
    assert all(slots[k] > 0 for k in chip_smoke.TEXTURED_CATEGORIES
               if k != "other"), slots
    # three compared (one launch of each kernel, and one more surface),
    # three steps (one of each)
    assert (kshade.launches_surface, kshade.launches_textured) == (
        before[0] + 3 * 2 + 3, before[1] + 3 + 3)


@pytest.mark.parametrize("texture_filter", ["nearest", "bilinear"])
def test_captured_steps_textured_against_plain(cuda, scene, texture_filter,
                                               monkeypatch):
    """Four captured render steps through the textured variant against
    four with the plain body captured: the survivors, the valid shadow
    rays and the accumulation (path counts and radiance) equal bit for
    bit, step by step."""
    sd = scene.to_device(cuda)
    cfg = small_config(64, 48, num_rays=4096, seed=7,
                       texture_filter=texture_filter)
    tables = tr.PacketTables(sd.bvh)
    fused = tr.Renderer(sd, cfg, tables=tables)
    plain = tr.Renderer(sd, cfg, tables=tables)
    assert fused.captured and plain.captured
    cam = camera_for_pose(0)
    n = cfg.num_rays
    for step in range(4):
        fused.step(cam, 1)
        with monkeypatch.context() as m:
            m.setattr(kshade, "variant", lambda *a: None)
            plain.step(cam, 1)
        torch.cuda.synchronize()
        a, b = fused.state, plain.state
        bit = torch.equal(a.accum, b.accum)
        print(f"captured textured step {step} {texture_filter}: carried "
              f"{int(a.n_carried)}/{int(b.n_carried)}, shadow rays "
              f"{int(a.shadow_rays)}/{int(b.shadow_rays)} of {n} slots, "
              f"accum bit for bit {bit}")
        assert int(a.n_carried) == int(b.n_carried)
        assert int(a.shadow_rays) == int(b.shadow_rays)
        assert bit
    for k in ("shade_surface", "shade_textured"):
        assert fused.replayed_launches.get(k, 0) > 0
        assert k not in plain.replayed_launches
    assert "shade" not in fused.replayed_launches


def test_chip_smoke_shade_at_step_textured(cuda, scene):
    """chip_smoke's shade check on a textured queue at a small size: the
    textured variant, a carried queue, no mismatch against the plain
    body, both kernels, the plain body and the bound timed."""
    import chip_smoke
    sd = scene.to_device(cuda)
    cfg = small_config(64, 48, num_rays=4096, seed=7, fuse_step_chains="off")
    out = chip_smoke.shade_at_step(tr.Renderer(sd, cfg), reps=2)
    assert out["variant"] == "textured" and out["filter"] == "bilinear"
    assert out["carried"] > 0 and out["rays"] == cfg.num_rays
    assert not any(out["mismatches"].values()), out["mismatches"]
    assert out["ms"] > 0 and out["plain_ms"] > 0 and out["bound_ms"] > 0
    assert out["taps"] > 0 and out["library_ms"] is None


def _ggx_spheres_scene(dev):
    """The small terrain of default-material triangles under the seven
    spheres, two of them GGX conductors: has_ggx is the one textured
    flag, and the triangles can shade from the traversal's hit normals."""
    import numpy as np
    from tyrant_tpu_torch.scene.procgen import terrain
    from tyrant_tpu_torch.scene.scene import GGX, Spheres
    sp = Spheres.default_seven()
    refl = sp.refl.copy()
    refl[[0, 5]] = GGX
    rough = np.full(7, 0.3, np.float32)
    rough[[0, 5]] = (0.2, 0.6)
    sp = Spheres(center=sp.center, radius=sp.radius, color=sp.color,
                 emission=sp.emission, refl=refl, roughness=rough)
    sd = Scene.from_triangles(*terrain(n_quads=32, towers=3), spheres=sp,
                              builder="numpy").to_device(dev)
    assert sd.has_ggx and sd.tri_default_mat and not sd.has_albedo_tex
    return sd


@pytest.mark.parametrize("normals", [False, True],
                         ids=["tri_shade", "kernel_normals"])
def test_ggx_spheres_match_plain(cuda, normals):
    """GGX spheres over default-material triangles, with the tri_shade
    rows and with the traversal's hit normals: the textured variant
    against the plain body, three frames from a fresh queue, GGX slots
    among them."""
    import chip_smoke
    sd = _ggx_spheres_scene(cuda)
    cfg = small_config(width=64, height=48, num_rays=4096, seed=99,
                       use_kernel_normals="on" if normals else "off")
    assert kshade.variant(cfg, sd, cuda) == kshade.TEXTURED
    tables = tr.PacketTables(sd.bvh)
    sky = tsky.SkyParams(cfg.sky)
    sun = tsky.sun_direction_from_position(SUN, cuda)
    cam = camera_for_pose(0).to_device(cfg, cuda)
    st = tr.init_state(cfg, cuda)
    ggx = 0
    for frame in range(3):
        rays = tr.merge_queue(cfg, st, cam)
        t, ident, is_tri, *tn = tr._intersect_scene(
            rays["origin"], rays["direction"], sd, tables, normals=normals)
        args = (cfg, sd, sky, sun, rays, t, ident, is_tri,
                tr._salted_frame(cfg, st.frame), tn[0] if normals else None)
        plain = tr._shade_plain(*args)
        fused = tr._shade(*args)
        got, n_eq, n_el = chip_smoke.shade_mismatches(
            fused, plain, hit_mask=t < VERY_FAR)
        rec = kshade.surface(cfg, sd, rays, t, ident, is_tri, args[8],
                             args[9])
        n_ggx = int(((rec.view(torch.int32)[:, 7] & 0xFF) == tr.GGX).sum())
        print(f"GGX spheres {'normals' if normals else 'tri_shade'} frame "
              f"{frame}: mismatches {json.dumps(got)}; float elements bit "
              f"for bit {n_eq}/{n_el}; GGX slots {n_ggx}")
        assert not any(got.values()), got
        ggx += n_ggx
        st = tr.render_step(st, sd, cam, sun, cfg=cfg, tables=tables,
                            sky_params=sky)
    assert ggx > 0
