"""The shade kernel (``csrc/shade.cu``, ``ops/kernels/shade.py``) against
its plain version (``render._shade_plain``) on the card, on the same
inputs: both variants (tri_shade rows on a scene of per-triangle
materials; the traversal's hit normals on a default-material scene), row
offsets 0 and 540, three frames each from a fresh queue on, with the
seven spheres of ``perfbench/configs/perftest_1m.json``; then four
captured render steps with the kernel against four with the plain body,
and ``chip_smoke.shade_at_step`` (the same check on the main path's
queues at full size) at a small size.

The survive flags, the shadow rays' valid flags, the sun-or-light pick,
pixel, bounces and last_specular must be equal; every float output within
1e-5 relative (a row's largest difference over its largest magnitude) on
every slot the step reads, the mismatches counted by the material each
slot shades with.  The kernel has no CPU mode, so these tests skip
without a CUDA device.  This file imports no JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_shade_kernel.py -s
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from tyrant_tpu_torch import render as tr
from tyrant_tpu_torch import sky as tsky
from tyrant_tpu_torch.bench.poses import camera_for_pose
from tyrant_tpu_torch.config import VERY_FAR, small_config
from tyrant_tpu_torch.ops.kernels import shade as kshade
from tyrant_tpu_torch.scene.procgen import terrain
from tyrant_tpu_torch.scene.scene import (DIFF, PHONG, REFR, SPEC, Scene,
                                          Spheres)

pytestmark = pytest.mark.gpu

CONFIG = Path(__file__).resolve().parents[1] / "perfbench" / "configs" \
    / "perftest_1m.json"
MATERIALS = ("miss", "DIFF", "SPEC", "REFR", "PHONG", "LIGHT")
SUN = (0.05, 0.3)
RTOL = 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the shade kernel has no CPU mode")
    return torch.device("cuda")


def _spheres() -> Spheres:
    rows = json.loads(CONFIG.read_text())["scene"]["spheres"]
    refl = {"DIFF": 0, "SPEC": 1, "REFR": 2, "PHONG": 3, "LIGHT": 4}
    return Spheres(
        center=np.array([r["center"] for r in rows], np.float32),
        radius=np.array([r["radius"] for r in rows], np.float32),
        color=np.array([r["color"] for r in rows], np.float32),
        emission=np.array([r["emission"] for r in rows], np.float32),
        refl=np.array([refl[r["material"]] for r in rows], np.int32))


def _scene(normals: bool, dev):
    """The small terrain with the seven spheres: default-material
    triangles for the normals variant, else a mix of DIFF, SPEC, REFR and
    PHONG triangles of random colours."""
    v0, v1, v2 = terrain(n_quads=32, towers=3)
    kw = {}
    if not normals:
        r = np.random.default_rng(11)
        kw = dict(tri_refl=r.choice(np.int32([DIFF, SPEC, REFR, PHONG]),
                                    v0.shape[0], p=[0.7, 0.1, 0.1, 0.1]),
                  tri_color=r.uniform(0.2, 1.0, (v0.shape[0], 3))
                  .astype(np.float32))
    sd = Scene.from_triangles(v0, v1, v2, spheres=_spheres(),
                              builder="numpy", **kw).to_device(dev)
    assert sd.tri_default_mat == normals
    return sd


def _material(sd, t, ident, is_tri, kn: bool):
    """The material each slot shades with, by the plain body's rule, as
    an index into MATERIALS."""
    hit = t < VERY_FAR
    sid = ident.clamp(0, sd.sphere_table.shape[0] - 1).long()
    tid = ident.clamp(0, sd.tri_shade.shape[0] - 1).long()
    refl_tri = torch.zeros_like(ident) if kn \
        else sd.tri_shade[tid, 3].to(torch.int32)
    refl = torch.where(hit & ~is_tri, sd.sphere_table[sid, 10].to(torch.int32),
                       refl_tri)
    return torch.where(hit, refl + 1, torch.zeros_like(refl))


def _rel_bad(a, b):
    """Rows (or elements) of a whose largest difference from b exceeds
    RTOL times b's largest magnitude."""
    if a.ndim == 1:
        a, b = a[:, None], b[:, None]
    err = (a - b).abs().amax(-1)
    return err > RTOL * b.abs().amax(-1)


def compare(label: str, fused, plain, mat) -> dict:
    """Counts of the slots where the kernel's outputs differ from the
    plain body's, field by field; prints them with the float elements
    equal bit for bit and the slots off by material, and returns them."""
    fc, fs, fn, fsh = fused
    pc, ps, pn, psh = plain
    far = float(np.float32(VERY_FAR))
    exact = {"survive": (fs, ps), "shadow.valid": (fsh["valid"], psh["valid"]),
             "sun_pick": (fsh["max_dist"] == far, psh["max_dist"] == far),
             "pixel": (fn["pixel"], pn["pixel"]),
             "bounces": (fn["bounces"], pn["bounces"]),
             "last_specular": (fn["last_specular"], pn["last_specular"])}
    valid = psh["valid"]
    floats = {"color": (fc, pc, None),
              "next.origin": (fn["origin"], pn["origin"], None),
              "next.direction": (fn["direction"], pn["direction"], None),
              "next.direct": (fn["direct"], pn["direct"], None),
              "shadow.origin": (fsh["origin"], psh["origin"], None),
              "shadow.direction": (fsh["direction"], psh["direction"], None),
              "shadow.max_dist": (fsh["max_dist"], psh["max_dist"], None),
              "shadow.color": (fsh["color"], psh["color"], valid)}
    out, any_bad = {}, torch.zeros_like(fs)
    n_eq = n_el = 0
    for name, (a, b) in exact.items():
        bad = a != b
        any_bad |= bad
        out[name] = int(bad.sum())
    for name, (a, b, mask) in floats.items():
        bad = _rel_bad(a, b)
        if mask is not None:
            bad &= mask
        any_bad |= bad
        out[name] = int(bad.sum())
        eq = (a == b) if mask is None else (a == b)[mask]
        n_eq, n_el = n_eq + int(eq.sum()), n_el + eq.numel()
    # an invalid shadow ray's colour is 0 in the kernel
    out["shadow.color.invalid_nonzero"] = int(
        (fsh["color"][~valid] != 0).any(-1).sum())
    by_mat = {m: (int((mat == k).sum()), int(((mat == k) & any_bad).sum()))
              for k, m in enumerate(MATERIALS)}
    print(f"shade kernel {label}: mismatches {json.dumps(out)}; float "
          f"elements bit for bit {n_eq}/{n_el}; (slots, slots off) by "
          f"material {json.dumps(by_mat)}")
    return out


@pytest.mark.parametrize("normals", [False, True],
                         ids=["tri_shade", "kernel_normals"])
@pytest.mark.parametrize("row_offset", [0, 540])
def test_shade_kernel_matches_plain(cuda, normals, row_offset):
    sd = _scene(normals, cuda)
    cfg = small_config(width=32, height=1080, num_rays=8192, seed=1234567891,
                       use_kernel_normals="on" if normals else "off")
    assert kshade.variant(cfg, sd, cuda) == kshade.BASE
    tables = tr.PacketTables(sd.bvh)
    sky = tsky.SkyParams(cfg.sky)
    sun = tsky.sun_direction_from_position(SUN, cuda)
    cam = camera_for_pose(0).to_device(cfg, cuda)
    local = 540
    st = tr.init_state(cfg, cuda, local_height=local)
    before = kshade.launches
    for frame in range(3):
        rays = tr.merge_queue(cfg, st, cam, local_height=local,
                              row_offset=row_offset)
        t, ident, is_tri, *tn = tr._intersect_scene(
            rays["origin"], rays["direction"], sd, tables, normals=normals)
        tri_normal = tn[0] if normals else None
        fs = tr._salted_frame(cfg, st.frame)
        plain = tr._shade_plain(cfg, sd, sky, sun, rays, t, ident, is_tri,
                                fs, tri_normal, row_offset)
        fused = kshade.shade(cfg, sd, sky, sun, rays, t, ident, is_tri, fs,
                             tri_normal, row_offset)
        torch.cuda.synchronize()
        mat = _material(sd, t, ident, is_tri, normals)
        got = compare(f"{'normals' if normals else 'tri_shade'} row_offset "
                      f"{row_offset} frame {frame} carried "
                      f"{int(st.n_carried)}", fused, plain, mat)
        if frame:
            assert int(st.n_carried) > 0
        assert not any(got.values()), got
        st = tr.render_step(st, sd, cam, sun, cfg=cfg, tables=tables,
                            sky_params=sky, local_height=local,
                            row_offset=row_offset)
    assert kshade.launches == before + 3 + 3  # three compared, three steps


@pytest.mark.parametrize("normals", [False, True],
                         ids=["tri_shade", "kernel_normals"])
def test_captured_steps_fused_against_plain(cuda, normals, monkeypatch):
    """Four captured render steps through the kernel against four with
    the plain body captured: the survivors and the valid shadow rays
    within 0.1% of the queue, and the path counts and radiance
    (1e-4) equal on at least 99.9% of the pixels, step by step."""
    sd = _scene(normals, cuda)
    cfg = small_config(64, 48, num_rays=4096, seed=7,
                       use_kernel_normals="on" if normals else "off")
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
        d_carried = abs(int(a.n_carried) - int(b.n_carried))
        d_shadow = abs(int(a.shadow_rays) - int(b.shadow_rays))
        same_count = (a.accum[:, 3] == b.accum[:, 3]).float().mean().item()
        close = torch.isclose(a.accum, b.accum, rtol=1e-4, atol=1e-4) \
            .all(-1).float().mean().item()
        bit = torch.equal(a.accum, b.accum)
        print(f"captured step {step} {'normals' if normals else 'tri_shade'}"
              f": carried {int(a.n_carried)}/{int(b.n_carried)}, shadow rays "
              f"{int(a.shadow_rays)}/{int(b.shadow_rays)}, counts equal "
              f"{same_count:.6f}, radiance close {close:.6f}, accum bit for "
              f"bit {bit}")
        assert d_carried <= 0.001 * n and d_shadow <= 0.001 * n * (step + 1)
        assert same_count >= 0.999 and close >= 0.999
    assert fused.replayed_launches.get("shade", 0) > 0
    assert "shade" not in plain.replayed_launches


@pytest.mark.parametrize("normals", [False, True],
                         ids=["tri_shade", "kernel_normals"])
def test_chip_smoke_shade_at_step(cuda, normals):
    """chip_smoke's shade check at a small size: the variant the
    configuration takes, a carried queue, no mismatch against the plain
    body, and the kernel, the plain body and the bound timed."""
    import chip_smoke
    sd = _scene(normals, cuda)
    cfg = small_config(64, 48, num_rays=4096, seed=7, fuse_step_chains="off",
                       use_kernel_normals="on" if normals else "off")
    out = chip_smoke.shade_at_step(tr.Renderer(sd, cfg), reps=2)
    assert out["variant"] == ("kernel_normals" if normals else "tri_shade")
    assert out["carried"] > 0 and out["rays"] == cfg.num_rays
    assert not any(out["mismatches"].values()), out["mismatches"]
    assert out["ms"] > 0 and out["plain_ms"] > 0 and out["bound_ms"] > 0
    assert out["library_ms"] is None
