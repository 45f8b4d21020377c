"""The default scene generator and reference, found by name, give what the
harness built and followed before they were named: the scene of
``perfbench/scenes/terrain_spheres.py`` is ``terrain.benchmark_scene``
and the configuration's sphere rows, bit for bit, and the step of
``pathtracer.make_step`` follows a checked step exactly as
``pathtracer.Scene`` and ``Step`` built from those rows do."""

import json

import numpy as np
import pytest
import torch

import pb_cpu
from perfbench import check, run, terrain
from perfbench.drive import Mix
from perfbench.reference import pathtracer

SEED = 2_147_483_733


@pytest.fixture(autouse=True)
def _threads():
    pb_cpu.pin_threads()


def _config(name="perftest_1m"):
    return json.loads((pb_cpu.ROOT / "perfbench" / "configs" /
                       f"{name}.json").read_text())


def _same(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape \
        and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("name", ["perftest_1m", "preset_128k"])
def test_the_default_generator_gives_the_terrain_and_the_rows(name):
    config = _config(name)
    _, kw, render, split = run.build(config, SEED, "cpu", pb_cpu.TINY)
    ter = config["scene"]["terrain"]
    want = terrain.benchmark_scene(pb_cpu.TINY["terrain"]["n_tris_target"],
                                   seed=ter["seed"])
    assert set(kw) == {"v0", "v1", "v2", "spheres"}
    for key, a in zip(("v0", "v1", "v2"), want):
        assert _same(kw[key], a), key
    rows = config["scene"]["spheres"]
    sph = kw["spheres"]
    for field in ("center", "radius", "color", "emission"):
        assert _same(getattr(sph, field),
                     np.array([r[field] for r in rows], np.float32)), field
    assert _same(sph.refl, np.array(
        [pathtracer.MATERIALS[r["material"]] for r in rows], np.int32))
    assert sph.roughness is None
    assert {"import_s", "terrain_s", "bvh_s", "tables_upload_s"} <= set(split)
    assert render == dict(config["render"], **pb_cpu.TINY["render"])


def _fresh_step(render: dict, n_slots: int = 512) -> check.Checked:
    """A step from a reset at the first pose of ``poses``: fresh camera
    rays at a sample of the queue's slots."""
    rng = np.random.default_rng(5)
    pix_all = check.queue_pixels(render, 0, 0, None, "cpu")
    slots = check.sample_slots(rng, render["num_rays"], n_slots, "cpu")
    u, j, _ = check.select(pix_all, slots, render["width"] * render["height"])
    n = j.shape[0]
    zeros = torch.zeros((n, 3))
    pose = Mix.load("poses").segments[0].pose(0)
    return check.Checked(
        pixels=u, slots=j, fresh=torch.ones(n, dtype=torch.bool),
        carried=dict(origin=zeros, direction=zeros, direct=zeros,
                     pending=zeros, pixel=torch.zeros(n, dtype=torch.int32),
                     bounces=torch.zeros(n, dtype=torch.int32),
                     last_specular=torch.zeros(n, dtype=torch.bool)),
        start=0, frame=1, pose=(pose.position, pose.horizontal_angle,
                                pose.vertical_angle),
        before=torch.zeros((u.shape[0], 4)),
        sampled=torch.searchsorted(j, slots), n_rays=render["num_rays"])


def test_make_step_follows_as_scene_and_step_did():
    config = _config()
    sc = config["scene"]
    render = dict(config["render"], **pb_cpu.TINY["render"])
    kw = run.scene_generator(config).make(
        dict(sc, terrain=dict(sc["terrain"], **pb_cpu.TINY["terrain"])))
    before = pathtracer.Step(pathtracer.Scene(
        kw["v0"], kw["v1"], kw["v2"], sc["spheres"], sc["sun_position"],
        "cpu"), render)
    now = run.reference_step(kw, config, render, "cpu")
    assert type(now).__module__ == "perfbench_reference_pathtracer"
    c = _fresh_step(render)
    rseed = run.run_seed(SEED)
    a = check.follow(before, c, rseed)
    b = check.follow(now, c, rseed)
    assert float(a["delta"][:, 3].sum()) > 0   # some paths ended
    for key in ("delta", "image", "shadow_valid"):
        assert torch.equal(a[key], b[key]), key
    assert a["surv"].keys() == b["surv"].keys()
    for key in a["surv"]:
        assert torch.equal(a["surv"][key], b["surv"][key]), key


def test_make_step_refuses_what_it_does_not_shade():
    config = _config()
    kw = run.scene_generator(config).make(dict(
        config["scene"], terrain=dict(config["scene"]["terrain"],
                                      n_tris_target=128)))
    kw["tri_uv"] = np.zeros((kw["v0"].shape[0], 3, 2), np.float32)
    with pytest.raises(ValueError, match="tri_uv"):
        pathtracer.make_step(kw, config, config["render"], "cpu")
