"""The ``fog_lights_1m`` configuration's own files: its scene generator
(``perfbench/scenes/fog_lights.py``) gives the program's lights scene
(``tyrant_tpu_torch/scene/files.py``: ``lamp_triangles``, the spheres of
``write_lights_description`` as ``load_description`` reads them, and
``DELTA_LIGHTS`` as ``DeltaLights.from_specs`` packs them) bit for bit;
its plain reference (``perfbench/reference/fog_lights.py``) loads without
a module of the program, JAX or the JAX package, and refuses what it does
not shade; each fault below, planted in the port's fogged many-light
shade, makes a run of the ``fog_lights_1m.poses`` cell at a tiny size not
correct; and the reference computed in bfloat16, the configuration's
lower-precision control, is not correct.

The faults are also planted at the cell's own size on the card:

    python3 scripts/fog_lights_faults.py --seeds 31,32 --seconds 3
"""

import dataclasses
import json
import subprocess
import sys

import numpy as np
import pytest
import torch

import pb_cpu
from perfbench import check, control, run, terrain
from perfbench.scenes import fog_lights

CELL = "fog_lights_1m.poses"
CONFIG = pb_cpu.ROOT / "perfbench" / "configs" / "fog_lights_1m.json"
# 96 lamps: 102 lights, so the pick reads alias rows
TINY = {"terrain": {"n_tris_target": 2048}, "lights": {"n_lamps": 96},
        "render": {"width": 64, "height": 48, "num_rays": 4096}}
SEED = 2_147_483_777


@pytest.fixture(autouse=True)
def _threads():
    pb_cpu.pin_threads()


def _same(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape \
        and a.tobytes() == b.tobytes()


def _scene(size: str) -> dict:
    scene = json.loads(CONFIG.read_text())["scene"]
    if size == "tiny":
        for group in ("terrain", "lights"):
            scene[group] = {**scene[group], **TINY[group]}
    return scene


@pytest.mark.parametrize("size", ["tiny", "full"])
def test_the_generator_is_the_programs_lights_scene(size, tmp_path):
    from tyrant_tpu_torch.scene import files
    from tyrant_tpu_torch.scene.description import load_description
    from tyrant_tpu_torch.scene.scene import DeltaLights
    scene = _scene(size)
    kw = fog_lights.make(scene)
    ter = scene["terrain"]
    v = terrain.benchmark_scene(ter["n_tris_target"], seed=ter["seed"])
    for key, a in zip(("v0", "v1", "v2"), v):
        assert _same(kw[key], a), key
    n_lamps = scene["lights"]["n_lamps"]
    refl, color = files.lamp_triangles(len(v[0]), n_lamps)
    assert _same(kw["tri_refl"], refl) and _same(kw["tri_color"], color)
    assert int((kw["tri_refl"] == fog_lights.LIGHT).sum()) == n_lamps
    want = DeltaLights.from_specs(files.DELTA_LIGHTS)
    for f in dataclasses.fields(DeltaLights):
        assert _same(getattr(kw["delta_lights"], f.name),
                     getattr(want, f.name)), f.name
    # the lights description's spheres: the seven with 0 and 5 emissive
    sph = load_description(files.write_lights_description(
        tmp_path / "lights.json")).scene.spheres
    for f in ("center", "radius", "color", "emission", "refl"):
        assert _same(getattr(kw["spheres"], f), getattr(sph, f)), f
    assert fog_lights.EMISSIVE_SPHERES == files.EMISSIVE_SPHERES
    assert fog_lights.LAMP_EMISSION == files.LAMP_EMISSION
    assert fog_lights.DELTA_LIGHTS == files.DELTA_LIGHTS
    if size == "full":
        assert len(kw["v0"]) == scene["triangles"]
        assert int((sph.refl == fog_lights.LIGHT).sum()) + n_lamps \
            + want.count == scene["lights"]["lights"]


def test_the_slab_is_the_terrains_z_range():
    """The configuration's fog slab: the full terrain's z range, as
    ``chip_smoke.fog_path`` computes it from the triangle corners."""
    config = json.loads(CONFIG.read_text())
    v0, v1, v2 = terrain.benchmark_scene(
        config["scene"]["terrain"]["n_tris_target"],
        seed=config["scene"]["terrain"]["seed"])
    corners = np.concatenate([v0, v0 + (v1 - v0), v0 + (v2 - v0)])
    assert config["render"]["fog_z_min"] == float(corners[:, 2].min())
    assert config["render"]["fog_z_max"] == float(corners[:, 2].max())


def test_the_reference_loads_nothing_of_the_program():
    code = (
        "import json, sys\n"
        f"sys.path.insert(0, {str(pb_cpu.ROOT)!r})\n"
        "from perfbench import run\n"
        "run.reference_module({'reference': 'fog_lights', 'scene': {}})\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    roots = set(json.loads(proc.stdout.splitlines()[-1]))
    assert "torch" in roots
    assert not roots & {"tyrant_tpu_torch", "tyrant_tpu", "jax", "jaxlib",
                        "flax"}


def test_the_reference_refuses_what_it_does_not_shade():
    config = json.loads(CONFIG.read_text())
    ref = run.reference_module(config)
    kw = fog_lights.make(_scene("tiny"))
    render = dict(config["render"])
    with pytest.raises(ValueError, match="tri_vn"):
        ref.make_step(dict(kw, tri_vn=np.zeros((len(kw["v0"]), 3, 3))),
                      config, render, "cpu")
    for key, value in (("mis", "on"), ("fog", "off"),
                       ("light_sampling", "uniform"), ("sampler", "sobol")):
        with pytest.raises(ValueError, match=key):
            ref.make_step(kw, config, dict(render, **{key: value}), "cpu")


# --------------------------------------------------------------------------
# faults planted in the port's fogged many-light shade
# --------------------------------------------------------------------------

def transmittance_dropped(mp):
    """Shadow rays cross the fog for free: every shadow segment's optical
    depth reads 0."""
    import tyrant_tpu_torch.render as tr
    mp.setattr(tr, "_fog_optical_depth",
               lambda sigma_t, rho0, k, s: torch.zeros_like(s))


def uniform_pick_weighted_as_power(mp):
    """The light is picked uniformly but weighted by the power pick's
    inverse probability."""
    import tyrant_tpu_torch.render as tr

    def pick(cfg, scene, lu, total):
        i = torch.clamp((lu * total).to(torch.int32), max=total - 1)
        inv = scene.light_alias[i.long(), 2] if total > 64 \
            else scene.light_inv_pdf[i.long()]
        return i, inv
    mp.setattr(tr, "_pick_light", pick)


def hg_g_ignored(mp):
    """The medium's phase function and its bounce take g = 0 (isotropic)
    for the configuration's 0.6."""
    import tyrant_tpu_torch.render as tr
    phase, sample = tr.hg_phase, tr.hg_sample_from_uniforms
    mp.setattr(tr, "hg_phase", lambda c, g: phase(c, 0.0))
    mp.setattr(tr, "hg_sample_from_uniforms",
               lambda d, g, u1, u2: sample(d, 0.0, u1, u2))


def spot_cone_ignored(mp):
    """The spot light shines everywhere at full intensity: its cone's
    cosines read -1 in the NEE sample (its power, and so the pick, kept)."""
    import tyrant_tpu_torch.render as tr
    samples = tr._shade_nee_samples

    def no_cone(cfg, scene, *a, **k):
        dl = scene.delta_lights
        dl = torch.cat([dl[:, :10], torch.where(dl[:, :1] == 1.0, -1.0,
                                                dl[:, 10:12])], 1)
        return samples(cfg, dataclasses.replace(scene, delta_lights=dl),
                       *a, **k)
    mp.setattr(tr, "_shade_nee_samples", no_cone)


def fog_stream_rekeyed(mp):
    """The free flight draws from the stream keyed 0xF07 for 0xF06."""
    from tyrant_tpu_torch.ops import rng
    seed_from = rng.seed_from

    def rekeyed(*parts, **k):
        if parts and isinstance(parts[-1], int) and parts[-1] == 0xF06:
            parts = parts[:-1] + (0xF07,)
        return seed_from(*parts, **k)
    mp.setattr(rng, "seed_from", rekeyed)


FAULTS = (transmittance_dropped, uniform_pick_weighted_as_power,
          hg_g_ignored, spot_cone_ignored, fog_stream_rekeyed)


def test_the_cell_is_correct_at_a_tiny_size():
    out = run.run(CELL, SEED, 0.3, False, device="cpu", tiny=TINY)
    assert out["correct"], out["checks"]
    assert out["checks"]["pixels_off_pct"]["value"] == 0.0


@pytest.mark.parametrize("fault", FAULTS, ids=lambda f: f.__name__)
def test_a_fault_in_the_fogged_many_light_shade_is_caught(monkeypatch,
                                                          fault):
    fault(monkeypatch)
    out = run.run(CELL, SEED, 0.3, False, device="cpu", tiny=TINY)
    assert not out["correct"], out["checks"]


def test_the_bfloat16_control_is_not_correct():
    lims = check.limits()
    (reading,) = control.control(CELL, [2_147_483_903], 0.3, device="cpu",
                                 tiny=TINY)
    program, ctrl = reading["program"], reading["control"]
    assert all(v <= lims[k] for k, v in program.items()), program
    assert any(v > lims[k] for k, v in ctrl.items()), ctrl
