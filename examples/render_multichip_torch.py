"""Data-parallel rendering over every visible CUDA device (pixel-strip
sharding, ``parallel/sharded.py``: one process, one row strip a device),
with the PyTorch/CUDA port; the counterpart of ``render_multichip.py``.

    python examples/render_multichip_torch.py
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from tyrant_tpu_torch.camera import Camera  # noqa: E402
from tyrant_tpu_torch.config import RenderConfig  # noqa: E402
from tyrant_tpu_torch.ops.tonemap import to_uint8  # noqa: E402
from tyrant_tpu_torch.parallel import ShardedRenderer  # noqa: E402
from tyrant_tpu_torch.scene.procgen import terrain  # noqa: E402
from tyrant_tpu_torch.scene.scene import Scene  # noqa: E402
from tyrant_tpu_torch.viewer import _to_png_bytes  # noqa: E402


def render(devices=None, out="multichip.png", steps=40) -> np.ndarray:
    """Render the terrain over ``devices`` (default: every visible CUDA
    device), one strip each, at 320 wide and 30 rows a device (32 when
    30 does not give a multiple of 8).  Writes the PNG, returns the
    image."""
    if devices is None:
        devices = ["cuda:%d" % i for i in range(torch.cuda.device_count())]
    n_dev = len(devices)
    cfg = RenderConfig(width=320, height=n_dev * 30 if (n_dev * 30) % 8 == 0
                       else n_dev * 32, num_rays=1 << 14)
    v0, v1, v2 = terrain(n_quads=64, towers=6)
    scene = Scene.from_triangles(v0, v1, v2)
    r = ShardedRenderer(scene, cfg, devices=devices)

    cam = Camera()
    cam.position = np.array([0.0, -260.0, 60.0], np.float32)
    cam.vertical_angle = -0.15
    r.step(cam, steps)

    img = to_uint8(r.image()).cpu().numpy()
    with open(out, "wb") as f:
        f.write(_to_png_bytes(img))
    print(f"rendered on {n_dev} devices -> {out}")
    return img


def main():
    render()


if __name__ == "__main__":
    main()
