"""The fogged many-light scene: the frozen terrain of ``perfbench/terrain.py``
and the configuration's sphere rows (:mod:`perfbench.scenes.terrain_spheres`)
lit by a frozen copy of the program's lights scene
(``tyrant_tpu_torch/scene/files.py``: ``lamp_triangles``, ``DELTA_LIGHTS``,
``EMISSIVE_SPHERES``, ``LAMP_EMISSION``; the delta lights' rows as
``scene/scene.py``'s ``DeltaLights.from_specs`` makes them), so that an
edit to the program's helpers cannot move the yardstick.

Spheres 0 and 5 of the configuration's rows become LIGHT spheres of their
``EMISSIVE_SPHERES`` emission beside the LIGHT sphere 6; ``n_lamps`` of
the mesh's triangles, taken with a stride through the triangle list,
become two-sided LIGHT triangles of emission ``LAMP_EMISSION``; a point, a
spot and a directional light hang over the terrain in pose 0's view.  The
configuration's ``scene.lights`` group gives ``n_lamps``.
``perfbench/tests/test_pb_fog_lights.py`` holds the arrays equal to those
of the program's helpers when this copy was taken.
"""

from __future__ import annotations

import numpy as np
from tyrant_tpu_torch.scene.scene import DeltaLights, Spheres

from perfbench.scenes import terrain_spheres

LIGHT = 4  # the program's material id
# the three delta lights: a warm point lamp, a spot and a dim directional
# fill (direction: from the light into the scene)
DELTA_LIGHTS = (
    {"type": "point", "position": [-20.0, 10.0, 45.0],
     "intensity": [3000.0, 2600.0, 2000.0]},
    {"type": "spot", "position": [30.0, 20.0, 80.0],
     "direction": [-0.3, -0.2, -1.0], "intensity": [12000.0, 12000.0,
                                                     14000.0],
     "inner_deg": 12.0, "outer_deg": 30.0},
    {"type": "directional", "direction": [0.4, 0.3, -1.0],
     "intensity": [0.4, 0.4, 0.45]})
DL_KINDS = {"point": 0, "spot": 1, "directional": 2}
# the sphere rows made emissive, by index, and the lamps' emission
EMISSIVE_SPHERES = {0: (2.0, 1.6, 1.2), 5: (3.0, 0.6, 0.4)}
LAMP_EMISSION = (4.0, 3.5, 3.0)


def lamp_triangles(n_tris: int, n_lamps: int):
    """(tri_refl [n_tris] i32, tri_color [n_tris, 3] f32): ``n_lamps``
    triangles at a stride of ``n_tris // n_lamps`` through the list made
    LIGHT of emission ``LAMP_EMISSION``; the rest diffuse white."""
    refl = np.zeros(n_tris, np.int32)
    color = np.ones((n_tris, 3), np.float32)
    lamps = np.arange(n_lamps) * (n_tris // n_lamps)
    refl[lamps] = LIGHT
    color[lamps] = LAMP_EMISSION
    return refl, color


def delta_lights(specs=DELTA_LIGHTS) -> DeltaLights:
    """The program's DeltaLights rows of ``specs``: unit directions (float64
    normalised, then float32), a spot's cone cosines from its degrees, 1.0
    for the others."""
    kind, pos, dirs, inten, ci, co = [], [], [], [], [], []
    for s in specs:
        k = DL_KINDS[s["type"]]
        kind.append(k)
        pos.append(s.get("position", (0.0, 0.0, 0.0)))
        d = np.asarray(s.get("direction", (0.0, 0.0, -1.0)), np.float64)
        dirs.append(d / max(np.linalg.norm(d), 1e-12))
        inten.append(s["intensity"])
        if k == 1:
            ci.append(np.cos(np.radians(float(s["inner_deg"]))))
            co.append(np.cos(np.radians(float(s["outer_deg"]))))
        else:
            ci.append(1.0)
            co.append(1.0)
    return DeltaLights(kind=np.asarray(kind, np.int32),
                       position=np.asarray(pos, np.float32).reshape(-1, 3),
                       direction=np.asarray(dirs, np.float32).reshape(-1, 3),
                       intensity=np.asarray(inten, np.float32).reshape(-1, 3),
                       cos_inner=np.asarray(ci, np.float32),
                       cos_outer=np.asarray(co, np.float32))


def emissive_spheres(s: Spheres) -> Spheres:
    """``s`` with the rows of ``EMISSIVE_SPHERES`` made LIGHT of their
    emission (their colour kept)."""
    refl, emission = s.refl.copy(), s.emission.copy()
    for i, em in EMISSIVE_SPHERES.items():
        refl[i] = LIGHT
        emission[i] = em
    return Spheres(center=s.center, radius=s.radius, color=s.color,
                   emission=emission, refl=refl)


def make(scene: dict) -> dict:
    """The terrain (``scene.terrain``) and sphere rows (``scene.spheres``)
    of :func:`terrain_spheres.make` under the lights: the emissive spheres,
    ``scene.lights.n_lamps`` lamps and the delta lights."""
    kw = terrain_spheres.make(scene)
    refl, color = lamp_triangles(len(kw["v0"]), scene["lights"]["n_lamps"])
    return dict(kw, spheres=emissive_spheres(kw["spheres"]), tri_refl=refl,
                tri_color=color, delta_lights=delta_lights())
