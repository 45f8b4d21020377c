"""The benchmark's first scene: the frozen procedural terrain of
``perfbench/terrain.py`` (``scene.terrain``: its size and seed) and the
configuration's sphere rows (``scene.spheres``)."""

from __future__ import annotations

import numpy as np
from tyrant_tpu_torch.scene.scene import Spheres

from perfbench import terrain

REFL = {"DIFF": 0, "SPEC": 1, "REFR": 2, "PHONG": 3, "LIGHT": 4}


def make(scene: dict) -> dict:
    ter = scene["terrain"]
    v0, v1, v2 = terrain.benchmark_scene(ter["n_tris_target"],
                                         seed=ter["seed"])
    rows = scene["spheres"]
    spheres = Spheres(
        center=np.array([r["center"] for r in rows], np.float32),
        radius=np.array([r["radius"] for r in rows], np.float32),
        color=np.array([r["color"] for r in rows], np.float32),
        emission=np.array([r["emission"] for r in rows], np.float32),
        refl=np.array([REFL[r["material"]] for r in rows], np.int32))
    return {"v0": v0, "v1": v1, "v2": v2, "spheres": spheres}
