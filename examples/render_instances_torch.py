"""Instancing demo with the PyTorch/CUDA port: a ring of meshes from ONE
shared MeshAsset; the counterpart of ``render_instances.py``.

Shows Scene.from_instances (scene/instancing.py): shared geometry placed
under affine transforms, flattened into one table so the traversal kernels
walk it at full speed.  Writes instances.png (+ optional instances.pfm with
--hdr).  The mesh is an argument: no file outside the repository is
looked for.

    python examples/render_instances_torch.py --mesh mesh.ply [--n 8]
      [--steps 64]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402

from tyrant_tpu_torch.camera import Camera  # noqa: E402
from tyrant_tpu_torch.config import RenderConfig  # noqa: E402
from tyrant_tpu_torch.render import Renderer  # noqa: E402
from tyrant_tpu_torch.scene.instancing import (MeshAsset,  # noqa: E402
                                               rotate_y, scale, translate)
from tyrant_tpu_torch.scene.scene import Scene  # noqa: E402
from tyrant_tpu_torch.utils.pfm import write_pfm  # noqa: E402
from tyrant_tpu_torch.viewer import _to_png_bytes  # noqa: E402


def ring_scene(mesh, n=8, builder="auto") -> Scene:
    """``n`` instances of ``mesh`` (scaled by 60) on a ring of radius 55,
    each turned to face the centre, in three sizes."""
    dragon = MeshAsset.load(mesh, scale=60.0)
    ring = 55.0
    insts = []
    for i in range(n):
        th = 2 * np.pi * i / n
        pos = [ring * np.sin(th), ring * np.cos(th) - 40.0, -20.0]
        s = 0.7 + 0.5 * (i % 3) / 2
        insts.append((0, translate(pos) @ rotate_y(th) @ scale(s)))
    return Scene.from_instances([dragon], insts, builder=builder)


def render(mesh, n=8, steps=64, width=960, height=540,
           rays=1 << 19, out="instances.png", hdr=None,
           device="cuda") -> np.ndarray:
    """Render the ring ``steps`` steps; writes the PNG (and the radiance
    as a PFM when ``hdr``), returns the image."""
    scene = ring_scene(mesh, n)
    print("scene:", scene.stats)

    cfg = RenderConfig(width=width, height=height, num_rays=rays)
    cam = Camera()
    cam.position = np.array([0.0, -150.0, 25.0], np.float32)
    cam.vertical_angle = -0.25
    r = Renderer(scene, cfg, device=device)
    r.step(cam, steps)
    img = r.image(uint8=True).cpu().numpy()
    with open(out, "wb") as f:
        f.write(_to_png_bytes(img))
    print("wrote", out)
    if hdr:
        write_pfm(hdr, r.radiance().cpu().numpy())
        print("wrote", hdr)
    return img


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", required=True, help="the instanced mesh")
    ap.add_argument("--n", type=int, default=8, help="instances in the ring")
    ap.add_argument("--steps", type=int, default=64)
    ap.add_argument("--width", type=int, default=960)
    ap.add_argument("--height", type=int, default=540)
    ap.add_argument("--rays", type=int, default=1 << 19)
    ap.add_argument("--out", default="instances.png")
    ap.add_argument("--hdr", default=None)
    args = ap.parse_args()
    render(args.mesh, args.n, args.steps, args.width, args.height,
           args.rays, args.out, args.hdr)


if __name__ == "__main__":
    main()
