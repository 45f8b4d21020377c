"""The benchmark's frozen copies equal what they were copied from: the
PERFORMANCE_TEST poses, the scripted flight, the Mrays/s arithmetic and
the procedural terrain, as the program gave them at the commit named in
``golden.json``."""

import hashlib
import json
from pathlib import Path

import numpy as np
import pytest

import pb_cpu
from perfbench import drive, terrain

GOLDEN = json.loads((Path(__file__).parent / "golden.json").read_text())
TRAFFIC = pb_cpu.ROOT / "perfbench" / "traffic"


def test_poses_are_upstreams():
    segs = json.loads((TRAFFIC / "poses.json").read_text())["segments"]
    assert [s["position"] for s in segs] == GOLDEN["poses"]["positions"]
    assert [s["angles"] for s in segs] == GOLDEN["poses"]["angles"]
    fly = json.loads((TRAFFIC / "fly.json").read_text())["segments"][0]
    assert fly["position"] == GOLDEN["poses"]["positions"][0]
    assert fly["angles"] == GOLDEN["poses"]["angles"][0]


def test_flight_is_fly_path():
    seg = drive.Mix.load("fly").segments[0]
    assert len(seg.poses) == len(GOLDEN["flight"]) == 120
    for pose, (pos, h, v) in zip(seg.poses, GOLDEN["flight"]):
        assert list(pose.position) == pos
        assert pose.horizontal_angle == h and pose.vertical_angle == v


@pytest.mark.parametrize("case", range(3))
def test_mrays_arithmetic(case):
    from perfbench.run import reader
    n, ms, shadow, steps, expected = GOLDEN["mrays_per_s"][case]

    class Ctx:
        render = {"num_rays": n}
        window = drive.Window(frames=steps, seconds=ms * 1e-3 * steps,
                              shadow_rays=shadow)
    got = reader("end_to_end", "mrays_per_s")(Ctx)
    assert got == pytest.approx(expected, rel=1e-12)


@pytest.mark.parametrize("target", ["2048", "65536", "1048576"])
def test_terrain_arrays(target):
    count, digest = GOLDEN["terrain"][target]
    v = terrain.benchmark_scene(int(target))
    h = hashlib.sha256()
    for a in v:
        h.update(np.ascontiguousarray(a).tobytes())
    assert v[0].shape[0] == count and h.hexdigest() == digest
