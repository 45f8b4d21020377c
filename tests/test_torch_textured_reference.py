"""The plain reference of the ``textured_1m`` configuration
(``perfbench/reference/textured.py``) against the port on the CPU, at a
small size of the benchmark's own scene (``perfbench/scenes/textured.py``
on the 2,192-triangle terrain): its bilinear taps, read from the
generator's images, equal the port's taps of the packed atlas bit for bit
on every map and wrap; a checked step of the ``textured_1m.poses`` cell
through ``perfbench/run.py`` comes out correct with no pixel off; and
each fault planted in the port's textured shade reads more than the
limit of pixels off.

The small scene is not the cell's density: over the same 400 x 400
terrain it has 4,096 leaves (the cell 65,536: a sixteenth) and 2,048
blend triangles (the cell 1,024: twice), at four rays a pixel (2,048 on
32 x 16; the cell about one).  It is sized so that each fault touches
enough of the checked pixels to read in a run of seconds: with 256
leaves, 16 blend triangles and 4,096 rays on 64 x 48, the cutout and
blend faults touched 0.04% and 0% of them.  So these tests show that
the check can see each fault, not that the cell's own size does.  This
file imports no JAX."""

import json
from pathlib import Path

import pytest
import torch

from perfbench import run
from perfbench.scenes import textured as generator
from tyrant_tpu_torch import render as tr
from tyrant_tpu_torch.ops import rng
from tyrant_tpu_torch.scene.scene import Scene

CELL = "textured_1m.poses"
CONFIG = Path(__file__).resolve().parents[1] / "perfbench" / "configs" \
    / "textured_1m.json"
TINY = {"terrain": {"n_tris_target": 2048},
        "textured": {"n_leaves": 4096, "n_blend": 2048, "albedo_px": 64,
                     "normal_px": 64, "rough_px": 32, "leaf_px": 32},
        "render": {"width": 32, "height": 16, "num_rays": 2048}}
SEED = 2_147_483_777
SECONDS = 0.3


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _scene_kw() -> dict:
    scene = json.loads(CONFIG.read_text())["scene"]
    for group, over in TINY.items():
        if group != "render":
            scene[group] = {**scene[group], **over}
    return generator.make(scene)


def test_reference_taps_are_the_atlas_taps():
    """At seeded uvs over three repeats each way, every map (albedo with
    its alpha, normal, roughness/metal, leaf, blend) under its wrap
    (repeat, repeat, mirror, clamp, repeat): the reference's RGBA taps of
    the source image equal the port's taps of the atlas bit for bit."""
    kw = _scene_kw()
    config = json.loads(CONFIG.read_text())
    maps = run.reference_module(config).Maps(
        kw["textures"], kw["texture_wraps"], "cpu", torch.float32)
    sd = Scene.from_triangles(**kw, builder="numpy").to_device("cpu")
    assert sorted({w for pair in kw["texture_wraps"] for w in pair}) \
        == [0, 1, 2]
    g = torch.Generator().manual_seed(5)
    n = 4096
    u = torch.rand(n, generator=g) * 6.0 - 3.0
    v = torch.rand(n, generator=g) * 6.0 - 3.0
    for k in range(len(kw["textures"])):
        texid = torch.full((n,), k, dtype=torch.int32)
        want = tr._sample_texture(sd, texid, u, v, "bilinear", channels=4)
        got = maps.sample(texid, u, v)
        assert torch.equal(got, want), (k, (got - want).abs().max())
    # a mixed batch takes each ray's own map
    texid = torch.randint(0, len(kw["textures"]), (n,), generator=g,
                          dtype=torch.int32)
    assert torch.equal(maps.sample(texid, u, v), tr._sample_texture(
        sd, texid, u, v, "bilinear", channels=4))


def test_checked_step_is_correct():
    out = run.run(CELL, SEED, SECONDS, False, device="cpu", tiny=TINY)
    assert out["correct"], out["checks"]
    assert out["checks"]["pixels_off_pct"]["value"] == 0.0


def _surface(monkeypatch, change):
    """The port's surface fetch with ``change`` applied to its outputs
    (is_sphere, srow, normal, refl_tri, color_tri, rough_tri, em_tri,
    cut_alpha, blend_tri)."""
    fetch = tr._shade_surface_fetch

    def changed(*a, **k):
        out = list(fetch(*a, **k))
        change(out)
        return tuple(out)
    monkeypatch.setattr(tr, "_shade_surface_fetch", changed)


def normal_map_ignored(monkeypatch):
    monkeypatch.setattr(tr, "_normal_mapped",
                        lambda scene, arow, uv_t, normal, *a, **k: normal)


def cutouts_opaque(monkeypatch):
    def change(out):
        out[7] = torch.where(out[8], out[7], torch.ones_like(out[7]))
    _surface(monkeypatch, change)


def blend_always_shaded(monkeypatch):
    def change(out):
        out[7] = torch.where(out[8], torch.ones_like(out[7]), out[7])
    _surface(monkeypatch, change)


def roughness_map_ignored(monkeypatch):
    def change(out):
        out[5] = torch.full_like(out[5], 0.3)
    _surface(monkeypatch, change)


def blend_stream_rekeyed(monkeypatch):
    seed_from = rng.seed_from

    def rekeyed(*parts, **k):
        if parts and isinstance(parts[-1], int) and parts[-1] == 0xB1E2D:
            parts = parts[:-1] + (0xB1E2E,)
        return seed_from(*parts, **k)
    monkeypatch.setattr(rng, "seed_from", rekeyed)


@pytest.mark.parametrize("fault", [
    normal_map_ignored, cutouts_opaque, blend_always_shaded,
    roughness_map_ignored, blend_stream_rekeyed], ids=lambda f: f.__name__)
def test_a_fault_in_the_textured_shade_is_caught(monkeypatch, fault):
    fault(monkeypatch)
    out = run.run(CELL, SEED, SECONDS, False, device="cpu", tiny=TINY)
    assert not out["correct"]
    assert out["checks"]["pixels_off_pct"]["value"] > 1.0, out["checks"]
