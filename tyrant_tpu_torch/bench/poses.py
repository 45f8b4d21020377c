"""The benchmark's fixed camera poses and its throughput metric, the port
of ``tyrant_tpu/bench/harness.py`` (the reference's PERFORMANCE_TEST
poses)."""

from __future__ import annotations

import numpy as np

from ..camera import Camera

TEST_POSITIONS = [(-0.119, -26.116, 32.537),
                  (-52.741, -44.67, 109.04),
                  (74.65, 2.77, 17.336)]
TEST_ANGLES = [(12.576, -0.518204),
               (-6470.568, -0.818204),
               (-10218.468, 0.081796)]


def camera_for_pose(i: int) -> Camera:
    cam = Camera()
    cam.position = np.asarray(TEST_POSITIONS[i], np.float32)
    cam.horizontal_angle, cam.vertical_angle = TEST_ANGLES[i]
    return cam


def mrays_per_s(num_rays: int, ms_per_step: float, shadow_rays: int,
                steps: int) -> float:
    """Path segments (the whole queue every step) plus valid NEE shadow
    rays, per second, in millions."""
    segs = num_rays / (ms_per_step * 1e-3)
    shadow = segs * (shadow_rays / (steps * num_rays))
    return (segs + shadow) / 1e6
