"""Material showcase with the PyTorch/CUDA port: one mesh, three looks,
via JSON mesh overrides; the counterpart of ``showcase_materials.py``.

Composes a scene entirely from a raw geometry file (no MTL needed): the
same mesh instanced three times as diffuse / metal (GGX) / glass, using
the scene-description per-mesh material overrides, then renders with
depth-of-field autofocus on the middle instance and a touch of bloom,
through the port's CLI.

Usage: python examples/showcase_materials_torch.py <mesh.ply> [out.png]
"""

import json
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from tyrant_tpu_torch import cli  # noqa: E402


def description(mesh) -> dict:
    """The scene: ``mesh`` three times, a ground sphere and a lamp."""
    return {
        "meshes": [
            {"name": "diffuse", "path": mesh, "scale": 0.4,
             "material": "diffuse", "color": [0.85, 0.25, 0.2]},
            {"name": "metal", "path": mesh, "scale": 0.4,
             "material": "metal", "color": [0.95, 0.75, 0.35],
             "roughness": 0.15},
            {"name": "glass", "path": mesh, "scale": 0.4,
             "material": "glass"},
        ],
        "instances": [
            {"mesh": "diffuse", "translate": [-48, 12, 0]},
            {"mesh": "metal", "translate": [0, 0, 0]},
            {"mesh": "glass", "translate": [48, 12, 0]},
        ],
        "spheres": [
            {"center": [0, 0, -10000], "radius": 10000,
             "color": [0.75, 0.75, 0.75]},
            {"center": [0, -80, 120], "radius": 9,
             "emission": [3, 3, 3], "material": "light"},
        ],
        "camera": {"position": [0, -58, 14], "vertical": -0.10},
        "sun": [0.9, 0.35],
        "render": {"bounces": 5, "tonemap": "aces", "exposure": 1.1},
    }


def render(mesh, out="showcase.png", width=960, height=540, rays=1 << 19,
           steps=400, device="cuda") -> None:
    """Write the description to a temporary JSON file and render it with
    ``cli render``."""
    desc = description(os.path.abspath(mesh))
    with tempfile.TemporaryDirectory() as td:
        sp = os.path.join(td, "showcase.json")
        with open(sp, "w") as f:
            json.dump(desc, f)
        cli.main(["render", "--scene", sp,
                  "--width", str(width), "--height", str(height),
                  "--rays", str(rays), "--steps", str(steps),
                  "--lens-radius", "1.2", "--focus-at", "0.5", "0.55",
                  "--bloom", "0.25", "--bloom-threshold", "0.9",
                  "--clamp", "25", "--out", out, "--device", device])
    print("wrote", out)


def main():
    render(sys.argv[1], sys.argv[2] if len(sys.argv) > 2 else "showcase.png")


if __name__ == "__main__":
    main()
