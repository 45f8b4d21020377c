"""Render the default 7-sphere scene (the reference's Cornell-style
arrangement, kernel.cu:674-680) to a PNG with the PyTorch/CUDA port; the
counterpart of ``render_spheres.py``.

Usage: python examples/render_spheres_torch.py [out.png]
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402

from tyrant_tpu_torch.camera import Camera  # noqa: E402
from tyrant_tpu_torch.config import RenderConfig  # noqa: E402
from tyrant_tpu_torch.render import Renderer  # noqa: E402
from tyrant_tpu_torch.scene.scene import Scene  # noqa: E402
from tyrant_tpu_torch.viewer import _to_png_bytes  # noqa: E402


def render(out="spheres.png", width=800, height=600, rays=1 << 19,
           steps=300, device="cuda") -> np.ndarray:
    """Render ``steps`` steps and write the PNG; returns the image."""
    cfg = RenderConfig(width=width, height=height, num_rays=rays)
    r = Renderer(Scene.load(None), cfg, device=device)

    cam = Camera()
    cam.position = np.array([0.0, -170.0, 40.0], np.float32)
    cam.vertical_angle = -0.10

    r.step(cam, steps)
    img = r.image(uint8=True).cpu().numpy()
    with open(out, "wb") as f:
        f.write(_to_png_bytes(img))
    print(f"wrote {out}")
    return img


def main():
    render(sys.argv[1] if len(sys.argv) > 1 else "spheres.png")


if __name__ == "__main__":
    main()
