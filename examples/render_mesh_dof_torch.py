"""Render a mesh with depth of field and a custom sun position, with
checkpoint/resume, with the PyTorch/CUDA port; the counterpart of
``render_mesh_dof.py``.  The checkpoint is the port's ``.npz`` state
(``checkpoint.save_state``), which the JAX package also loads.

Usage: python examples/render_mesh_dof_torch.py <mesh.ply> [out.png]
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402

from tyrant_tpu_torch.camera import Camera  # noqa: E402
from tyrant_tpu_torch.checkpoint import load_state, save_state  # noqa: E402
from tyrant_tpu_torch.config import RenderConfig  # noqa: E402
from tyrant_tpu_torch.render import Renderer  # noqa: E402
from tyrant_tpu_torch.scene.scene import Scene  # noqa: E402
from tyrant_tpu_torch.viewer import _to_png_bytes  # noqa: E402


def render(mesh, out="mesh.png", width=960, height=540, rays=1 << 19,
           chunks=6, steps_per_chunk=50, device="cuda") -> np.ndarray:
    """Render ``chunks`` chunks of ``steps_per_chunk`` steps, saving the
    state to ``out + ".ckpt.npz"`` after each; a checkpoint already there
    is resumed first.  Writes the PNG and returns the image."""
    ckpt = out + ".ckpt.npz"

    cfg = RenderConfig(width=width, height=height, num_rays=rays)
    scene = Scene.load(mesh)
    print("scene:", scene.stats)
    r = Renderer(scene, cfg, sun_position=(0.10, 0.25), device=device)

    center = scene.tri_vert.mean(0)
    cam = Camera()
    cam.position = (center + np.array([0, -70, 15], np.float32))
    cam.vertical_angle = -0.05
    cam.focal_distance = 20.0   # x3 scale applied internally (kernel.cu:286)
    cam.lens_radius = 0.35

    if os.path.exists(ckpt):
        # before the first step: the renderer starts from the saved state
        r.state, _ = load_state(ckpt, device=device)
        print(f"resumed at frame {int(r.state.frame)}")

    for _ in range(chunks):
        r.step(cam, steps_per_chunk)
        save_state(ckpt, r.state, metadata={"mesh": mesh})
        print(f"frame {int(r.state.frame)} checkpointed")

    img = r.image(uint8=True).cpu().numpy()
    with open(out, "wb") as f:
        f.write(_to_png_bytes(img))
    print(f"wrote {out}")
    return img


def main():
    render(sys.argv[1], sys.argv[2] if len(sys.argv) > 2 else "mesh.png")


if __name__ == "__main__":
    main()
