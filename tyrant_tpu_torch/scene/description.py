"""JSON scene descriptions (beyond-reference).

The reference hard-codes its world: one mesh path (main.cpp:113) and seven
spheres inside the orchestrator (kernel.cu:674-681).  Production scenes are
COMPOSED — several meshes under transforms, custom lights, a camera, an
environment — so the framework provides a declarative JSON format gluing
the existing pieces (Scene.from_instances, Spheres, Camera, fog/render
config) into one shareable file:

```json
{
  "meshes":   [{"name": "bunny", "path": "bunny.ply", "scale": 2.0,
                "material": "glass", "color": [1, 1, 1],
                "roughness": 0.1}],
  "instances": [
    {"mesh": "bunny", "translate": [0, 40, 0], "rotate_z": 45},
    {"mesh": "bunny", "matrix": [[1,0,0,10],[0,1,0,0],[0,0,1,0]]}
  ],
  "spheres": [
    {"center": [0,-80,120], "radius": 9, "emission": [3,3,3],
     "material": "light"}
  ],
  "default_spheres": false,
  "envmap": "sky.pfm",
  "camera": {"position": [0,-170,40], "vertical": -0.1,
             "focal_distance": 1.0, "lens_radius": 0.0},
  "sun": [0.05, 0.3],
  "fog": {"scatter": 0.005, "absorb": 0.0, "g": 0.4, "z": [0, 70], "falloff": 0.02},
  "render": {"bounces": 5, "tonemap": "aces", "exposure": 1.2,
             "mis": true, "sampler": "sobol", "clamp": 0.0}
}
```

Every section is optional.  Instance transforms are either an explicit
[3,4]/[4,4] "matrix" or composed from "scale" (scalar or [3]),
"rotate_x/y/z" (degrees, applied x then y then z) and "translate".
Omitting "instances" places each mesh once at the identity.  The loader
returns a :class:`SceneBundle`; the CLI consumes it when ``--scene`` ends
in ``.json``, with explicitly-passed CLI flags overriding the file.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
from typing import Optional

import numpy as np

from ..camera import Camera
from ..config import BVHConfig
from .scene import (DIFF, GGX, LIGHT, PHONG, REFR, RREFR, SPEC, DeltaLights, Scene,
                    Spheres)

_MATERIALS = {"diffuse": DIFF, "specular": SPEC, "mirror": SPEC,
              "refractive": REFR, "glass": REFR, "phong": PHONG,
              "light": LIGHT, "ggx": GGX, "metal": GGX,
              "rough_glass": RREFR, "frosted": RREFR}

# "render" keys -> RenderConfig fields (bool -> on/off where needed)
_RENDER_KEYS = {
    "bounces": ("max_bounces", int),
    "tonemap": ("tonemap", str),
    "exposure": ("exposure", float),
    "clamp": ("radiance_clamp", float),
    "mis": ("mis", "onoff"),
    "sampler": ("sampler", str),
    "light_sampling": ("light_sampling", str),
    "denoise": ("denoise", "onoff"),
    "adaptive": ("adaptive_sampling", "onoff"),
    "texture_filter": ("texture_filter", str),
    "projection": ("projection", str),
    "fisheye_fov": ("fisheye_fov_degrees", float),
    "ortho_height": ("ortho_height", float),
    "shutter": ("motion_blur", float),
    "dispersion": ("dispersion", float),
    "bokeh_blades": ("bokeh_blades", int),
    "bokeh_rotation": ("bokeh_rotation", float),
}


@dataclasses.dataclass
class SceneBundle:
    """Everything a JSON description specifies: the built scene plus the
    optional camera/sun/config settings for the CLI or API to apply."""

    scene: Scene
    camera: Optional[Camera] = None
    sun: Optional[tuple] = None
    # RenderConfig field overrides (includes fog settings when present)
    config: dict = dataclasses.field(default_factory=dict)


def _affine(inst: dict) -> np.ndarray:
    """[3,4] world-from-object transform from an instance entry."""
    if "matrix" in inst:
        m = np.asarray(inst["matrix"], np.float64)
        if m.shape == (4, 4):
            m = m[:3, :]
        if m.shape != (3, 4):
            raise ValueError(f"instance matrix must be [3,4] or [4,4], "
                             f"got {m.shape}")
        return m.astype(np.float32)
    s = inst.get("scale", 1.0)
    s = np.diag([s, s, s] if np.isscalar(s) else list(s)).astype(np.float64)
    rot = np.eye(3)
    for axis, key in ((0, "rotate_x"), (1, "rotate_y"), (2, "rotate_z")):
        if key in inst:
            a = math.radians(float(inst[key]))
            c, si = math.cos(a), math.sin(a)
            r = np.eye(3)
            i, j = [(1, 2), (0, 2), (0, 1)][axis]
            r[i, i] = c
            r[j, j] = c
            r[i, j] = -si if axis != 1 else si
            r[j, i] = si if axis != 1 else -si
            rot = r @ rot
    t = np.asarray(inst.get("translate", (0.0, 0.0, 0.0)), np.float64)
    m = np.zeros((3, 4))
    m[:, :3] = rot @ s
    m[:, 3] = t
    return m.astype(np.float32)


def _spheres_from(entries, default_spheres: bool) -> Optional[Spheres]:
    base = Spheres.default_seven() if default_spheres else None
    if not entries:
        return base
    center = [np.asarray(e["center"], np.float32) for e in entries]
    radius = [float(e["radius"]) for e in entries]
    color = [np.asarray(e.get("color", (1, 1, 1)), np.float32)
             for e in entries]
    emission = [np.asarray(e.get("emission", (0, 0, 0)), np.float32)
                for e in entries]
    refl = []
    rough = []
    for e in entries:
        mat = str(e.get("material", "diffuse")).lower()
        if mat not in _MATERIALS:
            raise ValueError(f"unknown sphere material {mat!r}; expected "
                             f"one of {sorted(_MATERIALS)}")
        refl.append(_MATERIALS[mat])
        rough.append(float(e.get("roughness", 0.3)))
    out = Spheres(center=np.asarray(center, np.float32).reshape(-1, 3),
                  radius=np.asarray(radius, np.float32),
                  color=np.asarray(color, np.float32).reshape(-1, 3),
                  emission=np.asarray(emission, np.float32).reshape(-1, 3),
                  refl=np.asarray(refl, np.int32),
                  roughness=np.asarray(rough, np.float32))
    if base is None:
        return out
    return Spheres(
        center=np.concatenate([base.center, out.center]),
        radius=np.concatenate([base.radius, out.radius]),
        color=np.concatenate([base.color, out.color]),
        emission=np.concatenate([base.emission, out.emission]),
        refl=np.concatenate([base.refl, out.refl]),
        roughness=np.concatenate([
            np.full(base.count, 0.3, np.float32), out.roughness]))


def load_description(path: str, builder: str = "auto",
                     bvh_cfg: BVHConfig = BVHConfig()) -> SceneBundle:
    """Parse a JSON scene description and build the Scene.

    Relative asset paths resolve against the JSON file's directory."""
    with open(path) as f:
        desc = json.load(f)
    known = {"meshes", "instances", "spheres", "default_spheres", "envmap",
             "camera", "sun", "fog", "render", "lights"}
    unknown = set(desc) - known
    if unknown:
        raise ValueError(f"unknown scene-description keys {sorted(unknown)}; "
                         f"expected a subset of {sorted(known)}")
    base_dir = os.path.dirname(os.path.abspath(path))

    def resolve(p):
        return p if os.path.isabs(p) else os.path.join(base_dir, p)

    spheres = _spheres_from(desc.get("spheres", ()),
                            bool(desc.get("default_spheres",
                                          "spheres" not in desc)))
    envmap = desc.get("envmap")
    if envmap:
        envmap = resolve(envmap)
    # delta lights (point/spot/directional; scene.DeltaLights.from_specs)
    dlights = (DeltaLights.from_specs(desc["lights"])
               if desc.get("lights") else None)

    mesh_entries = desc.get("meshes", ())
    if mesh_entries:
        from .instancing import MeshAsset
        names = {}
        assets = []
        for i, m in enumerate(mesh_entries):
            asset = MeshAsset.load(resolve(m["path"]),
                                   scale=float(m.get("scale", 1.0)))
            # per-mesh overrides (beyond the file's own materials): force
            # the whole asset to one material / colour / roughness —
            # composition needs raw geometry under scene-chosen looks
            mat = m.get("material")
            n = asset.n_tris
            if mat is not None:
                code = _MATERIALS.get(str(mat).lower())
                if code is None:
                    raise ValueError(
                        f"unknown mesh material {mat!r}; expected one of "
                        f"{sorted(_MATERIALS)}")
                asset.tri_refl = np.full(n, code, np.int32)
                col = (m.get("emission", (1.0, 1.0, 1.0)) if code == LIGHT
                       else m.get("color", (1.0, 1.0, 1.0)))
                asset.tri_color = np.tile(
                    np.asarray(col, np.float32), (n, 1))
                # the override forces the LOOK: drop the file's per-texel
                # material state (stale roughness/metal/blend maps would
                # fight the forced material — e.g. a rough-map tap
                # overwrites the REFR IOR lane); albedo and normal maps
                # stay (they compose with any material)
                asset.tri_rtex = None
                asset.tri_metal = None
                asset.tri_blend = None
                asset.tri_rough = None
                asset.tri_ior = None
                if "roughness" in m:
                    asset.tri_rough = np.full(n, float(m["roughness"]),
                                              np.float32)
                if "ior" in m:
                    asset.tri_ior = np.full(n, float(m["ior"]), np.float32)
            elif "color" in m:
                asset.tri_color = np.tile(
                    np.asarray(m["color"], np.float32), (n, 1))
            names[m.get("name", f"mesh{i}")] = i
            assets.append(asset)
        inst_entries = desc.get("instances")
        if inst_entries is None:
            # every mesh once, at the identity
            ident = np.hstack([np.eye(3), np.zeros((3, 1))]).astype(np.float32)
            instances = [(i, ident) for i in range(len(assets))]
        else:
            instances = []
            for inst in inst_entries:
                ref = inst.get("mesh", 0)
                mid = names[ref] if isinstance(ref, str) else int(ref)
                if not 0 <= mid < len(assets):
                    raise ValueError(f"instance references unknown mesh "
                                     f"{ref!r}")
                instances.append((mid, _affine(inst)))
        scene = Scene.from_instances(assets, instances, spheres=spheres,
                                     bvh_cfg=bvh_cfg, builder=builder,
                                     envmap=envmap, delta_lights=dlights)
    else:
        if desc.get("instances"):
            raise ValueError("'instances' requires a 'meshes' list")
        scene = Scene.load(None, spheres=spheres, envmap=envmap,
                           delta_lights=dlights)

    camera = None
    if "camera" in desc:
        c = desc["camera"]
        camera = Camera()
        if "position" in c:
            camera.position = np.asarray(c["position"], np.float32)
        camera.horizontal_angle = float(c.get("horizontal", 0.0))
        camera.vertical_angle = float(c.get("vertical", 0.0))
        camera.focal_distance = float(c.get("focal_distance", 1.0))
        camera.lens_radius = float(c.get("lens_radius", 0.0))

    config: dict = {}
    if "fog" in desc:
        fg = desc["fog"]
        config["fog"] = "on"
        config["fog_sigma_s"] = float(fg.get("scatter", 0.02))
        config["fog_sigma_a"] = float(fg.get("absorb", 0.0))
        config["fog_g"] = float(fg.get("g", 0.0))
        config["fog_falloff"] = float(fg.get("falloff", 0.0))
        z = fg.get("z", (-1e8, 1e8))
        config["fog_z_min"], config["fog_z_max"] = float(z[0]), float(z[1])
    for key, val in desc.get("render", {}).items():
        if key not in _RENDER_KEYS:
            raise ValueError(f"unknown render key {key!r}; expected one of "
                             f"{sorted(_RENDER_KEYS)}")
        field, conv = _RENDER_KEYS[key]
        if conv == "onoff":
            config[field] = "on" if val else "off"
        else:
            config[field] = conv(val)

    sun = tuple(float(v) for v in desc["sun"]) if "sun" in desc else None
    return SceneBundle(scene=scene, camera=camera, sun=sun, config=config)
