"""The interactive fly-through: a camera that moves every frame, one
wavefront step a frame and the displayed image resolved each frame, the
port of ``scripts/interactive_fps.py`` (``fly_path``, ``measure``)
without its remote-display knobs.

Every frame moves the camera (so the accumulation resets and the step
renders fresh camera rays), runs ``steps_per_frame`` steps, resolves
``image(uint8=True)`` and copies it to the host, as a viewer shows it.
:func:`run_interactive` times that loop from pose 0 and, for comparison,
with the camera still at pose 0 (the image then converges).

    from tyrant_tpu_torch.bench.interactive import run_interactive
    from tyrant_tpu_torch.config import interactive_config
    run_interactive(scene, interactive_config())
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..config import RenderConfig
from ..render import Renderer
from .poses import camera_for_pose

WARMUP_FRAMES = 2  # frames left out of the times (the first captures)


def fly_path(cam, i: int) -> None:
    """The scripted flight: forward with a strafe, turning, the pitch
    swaying."""
    cam.move(forward=0.6, strafe=0.35, delta=1.0)
    cam.look(2.0, 0.4 * np.sin(i * 0.15))


def frame(renderer: Renderer, cam, i: int, steps_per_frame: int = 1,
          move: bool = True) -> np.ndarray:
    """One displayed frame: move, step, resolve; returns the frame's
    [H, W, 3] uint8 pixels on the host."""
    if move:
        fly_path(cam, i)
    renderer.step(cam, steps_per_frame)
    return renderer.image(uint8=True).cpu().numpy()


def measure(renderer: Renderer, cam, n_frames: int,
            steps_per_frame: int = 1, move: bool = True) -> dict:
    """Wall ms a frame over ``n_frames`` frames after WARMUP_FRAMES more:
    mean, median and min, and the frames per second of the mean."""
    times = []
    for i in range(WARMUP_FRAMES + n_frames):
        t0 = time.perf_counter()
        frame(renderer, cam, i, steps_per_frame, move)
        times.append(time.perf_counter() - t0)
    ms = np.asarray(times[WARMUP_FRAMES:]) * 1e3
    return dict(mean_ms=float(ms.mean()), median_ms=float(np.median(ms)),
                min_ms=float(ms.min()), fps=1e3 / float(ms.mean()),
                frames=n_frames)


def run_interactive(scene, cfg: RenderConfig, n_frames: int = 40,
                    steps_per_frame: int = 1, device="cuda",
                    sun_position=(0.05, 0.3), tables=None) -> dict:
    """The fly-through from pose 0 and the still camera at pose 0, each
    ``n_frames`` timed frames on one Renderer: {"moving": ..., "still":
    ..., "renderer": the Renderer}."""
    ren = Renderer(scene, cfg, device=device, sun_position=sun_position,
                   tables=tables)
    moving = measure(ren, camera_for_pose(0), n_frames, steps_per_frame)
    still = measure(ren, camera_for_pose(0), n_frames, steps_per_frame,
                    move=False)
    if ren.device.type == "cuda":
        torch.cuda.synchronize(ren.device)
    return dict(moving=moving, still=still, renderer=ren)
