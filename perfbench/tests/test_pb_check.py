"""``correct`` on the CPU at a tiny size: a sound run of each cell is
correct; the control (the plain reference in bfloat16 in the program's
place) reads over the limits; and runs whose timed path is broken
underneath (:mod:`perfbench.faults`: the step leaves its state unchanged,
half of the batch is left out of the accumulation, every answer is
altered where it is made, the count of shadow rays is inflated, the
display resolve is wrong) come out not correct.  The exchange between
chips is not among the faults: every cell runs on one card."""

import pytest

import pb_cpu
from perfbench import check, control, faults, run

FLY_CELLS = [c for c in pb_cpu.CELLS if c.endswith(".fly")]


@pytest.fixture(autouse=True)
def _threads():
    pb_cpu.pin_threads()


def _run(cell, seed=2_147_483_700):
    return run.run(cell, seed, 1.0, False, device="cpu", tiny=pb_cpu.TINY)


@pytest.mark.parametrize("cell", pb_cpu.CELLS)
def test_a_sound_run_is_correct(cell):
    out = _run(cell)
    assert out["correct"], out["checks"]
    assert list(out)[-1] == "checks"
    for v in out["checks"].values():
        assert v["value"] <= v["limit"]


@pytest.mark.parametrize("cell", pb_cpu.CELLS)
def test_the_control_fails(cell):
    lims = check.limits()
    (r,) = control.control(cell, [91], 1.0, device="cpu", tiny=pb_cpu.TINY)
    assert all(v <= lims[k] for k, v in r["program"].items()), r
    assert any(v > lims[k] for k, v in r["control"].items()), r
    assert r["control"]["pixels_off_pct"] > 10 * lims["pixels_off_pct"]


@pytest.mark.parametrize("fault", faults.STEP_FAULTS)
@pytest.mark.parametrize("cell", pb_cpu.CELLS)
def test_a_broken_step_is_not_correct(monkeypatch, cell, fault):
    fault(monkeypatch)
    out = _run(cell)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("fault", faults.DISPLAY_FAULTS)
@pytest.mark.parametrize("cell", FLY_CELLS)
def test_a_broken_display_is_not_correct(monkeypatch, cell, fault):
    fault(monkeypatch)
    out = _run(cell)
    d = out["checks"]["display_off_pct"]
    assert d["value"] > d["limit"], out["checks"]


def test_an_overcount_of_shadow_rays_is_not_correct(monkeypatch):
    faults.shadow_overcount(monkeypatch)
    out = _run("perftest_1m.poses")
    z = out["checks"]["shadow_count_z"]
    assert z["value"] > z["limit"], out["checks"]
