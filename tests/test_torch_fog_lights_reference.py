"""The plain reference of the ``fog_lights_1m`` configuration
(``perfbench/reference/fog_lights.py``) against the port on the CPU, at a
small size of the benchmark's own scene (``perfbench/scenes/fog_lights.py``
on the 2,192-triangle terrain): six steps of the ``fog_lights_1m.poses``
cell's Renderer at pose 0, each followed by the reference over every
queue slot from the state the step started from (fresh and carried rays
alike), give every pixel's accumulation delta within ``check.py``'s
tolerance, the same carried rays and the same count of valid shadow rays.
With 96 lamps the pick reads Vose alias rows (102 lights, over 64); with
32 it reads the CDF (38 lights).  Each case is required to run the
features it is there for: medium events, and NEE picks of a sphere, a
lamp triangle and each delta light.  This file imports no JAX."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from perfbench import check, run
from perfbench.drive import Driver, Mix

CELL = "fog_lights_1m.poses"
CONFIG = Path(__file__).resolve().parents[1] / "perfbench" / "configs" \
    / "fog_lights_1m.json"
SEED = 2_147_483_801
STEPS = 6


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _tiny(n_lamps: int) -> dict:
    return {"terrain": {"n_tris_target": 2048},
            "lights": {"n_lamps": n_lamps},
            "render": {"width": 64, "height": 48, "num_rays": 4096}}


@pytest.mark.parametrize("n_lamps,pick", [(96, "alias"), (32, "cdf")])
def test_six_steps_follow_the_reference(n_lamps, pick):
    config = json.loads(CONFIG.read_text())
    ren, kw, render, _ = run.build(config, SEED, "cpu", _tiny(n_lamps))
    sd = ren.scene
    total = len(sd.light_indices) + sd.n_tri_lights + sd.n_delta_lights
    assert (sd.n_tri_lights, sd.n_delta_lights, len(sd.light_indices)) \
        == (n_lamps, 3, 3)
    assert (total > 64) == (pick == "alias")
    step = run.reference_step(kw, config, render, "cpu")
    assert step.sc.lights.count == total
    if pick == "alias":
        # the reference's own Vose rows are the program's
        assert torch.equal(step.sc.lights.alias, sd.light_alias)
    outs = []  # what each followed step did, as the reference saw it
    follow = step.run
    step.run = lambda *a: outs.append(follow(*a)) or outs[-1]
    mix = Mix.load("poses")
    driver = Driver(ren, mix, run.camera_factory())
    pose = mix.segments[0].pose(0)
    rng = np.random.default_rng(SEED)
    seen = {"fog": 0, "sphere": 0, "tri": 0, "delta": set(), "carried": 0}
    n_s, n_t = len(sd.light_indices), sd.n_tri_lights
    for k in range(STEPS):
        c = run.checked_step(driver, pose, render, rng, check)
        assert c.slots.shape[0] == render["num_rays"]  # every slot followed
        ref = check.follow(step, c, run.run_seed(SEED))
        ok = check.step_ok(c, check.program_judged(c), ref)
        assert ok.all(), (k, int((~ok).sum()), ok.shape[0])
        assert int(ref["shadow_valid"].sum()) == c.shadow, k
        out = outs[-1]
        lit = out["nee_light"] & out["shadow_valid"]
        seen["fog"] += int(out["is_fog"].sum())
        seen["sphere"] += int((lit & (out["pick"] < n_s)).sum())
        seen["tri"] += int((lit & (out["pick"] >= n_s)
                            & (out["pick"] < n_s + n_t)).sum())
        seen["delta"] |= set((out["pick"][lit & (out["pick"] >= n_s + n_t)]
                              - n_s - n_t).tolist())
        seen["carried"] += int((~c.fresh).sum())
    assert seen["fog"] > 0 and seen["sphere"] > 0 and seen["tri"] > 0, seen
    assert seen["delta"] == {0, 1, 2} and seen["carried"] > 0, seen
