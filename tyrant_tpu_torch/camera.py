"""Camera model, the port of ``tyrant_tpu/camera.py``: the pose, the fly
controls (:meth:`Camera.move`, :meth:`Camera.look`), aiming at a point,
the projection basis and the upload.
:class:`Camera` is host state (numpy); :meth:`Camera.to_device` gives the
per-frame :class:`CameraParams` tensors on a named device."""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from .config import PI, RenderConfig


@dataclasses.dataclass
class CameraParams:
    """Device-side camera constants for one frame."""

    position: torch.Tensor        # [3]
    direction: torch.Tensor       # [3]
    right: torch.Tensor           # [3] includes 1.5 * aspect
    up: torch.Tensor              # [3] includes 1.5
    focal_distance: torch.Tensor  # scalar
    lens_radius: torch.Tensor     # scalar


@dataclasses.dataclass
class Camera:
    """Host-side interactive camera state."""

    position: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array([1.0, 30.0, 90.0], np.float32))
    up: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array([0.0, 0.0, 1.0], np.float32))
    horizontal_angle: float = 0.0
    vertical_angle: float = 0.0
    focal_distance: float = 1.0
    lens_radius: float = 0.0

    @property
    def direction(self) -> np.ndarray:
        cv, sv = math.cos(self.vertical_angle), math.sin(self.vertical_angle)
        ch, sh = math.cos(self.horizontal_angle), math.sin(self.horizontal_angle)
        d = np.array([cv * sh, cv * ch, sv], np.float32)
        return d / np.linalg.norm(d)

    def move(self, forward=0.0, strafe=0.0, vertical=0.0, delta=1.0,
             sprint=False):
        """WASD/space/ctrl movement along the view direction, its right
        and world up; ``sprint`` (shift) moves 40x as far."""
        speed = (40.0 if sprint else 1.0) * delta
        d = self.direction
        disp = np.cross(d, self.up)
        disp = disp / np.linalg.norm(disp)
        self.position = (self.position + d * (forward * speed)
                         + disp * (strafe * speed)
                         + np.array([0, 0, vertical * speed], np.float32))

    def look(self, dx: float, dy: float):
        """Mouse look: 0.012 rad a pixel, pitch clamped short of the
        poles."""
        self.horizontal_angle += dx * 0.012
        self.vertical_angle -= dy * 0.012
        self.vertical_angle = max(-PI / 2 + 1e-3,
                                  min(self.vertical_angle, PI / 2 - 1e-3))

    def look_at(self, target):
        """Aim at a world point: set the spherical angles so ``direction``
        points at ``target``, pitch clamped short of the poles."""
        d = np.asarray(target, np.float64) - np.asarray(self.position,
                                                        np.float64)
        n = np.linalg.norm(d)
        if n < 1e-12:
            return
        d = d / n
        self.vertical_angle = max(-math.pi / 2 + 1e-3,
                                  min(float(np.arcsin(np.clip(d[2], -1, 1))),
                                      math.pi / 2 - 1e-3))
        self.horizontal_angle = float(np.arctan2(d[0], d[1]))

    def basis(self, cfg: RenderConfig):
        """Projection basis (right scaled by 1.5 * aspect, up by 1.5)."""
        d = self.direction
        right = np.cross(d, self.up)
        right = right / np.linalg.norm(right)
        up2 = np.cross(right, d)
        up2 = up2 / np.linalg.norm(up2)
        aspect = cfg.width / cfg.height
        return (right * 1.5 * aspect).astype(np.float32), \
            (up2 * 1.5).astype(np.float32)

    def to_device(self, cfg: RenderConfig, device) -> CameraParams:
        right, up2 = self.basis(cfg)

        def t(x):
            return torch.as_tensor(np.asarray(x, np.float32), device=device)
        return CameraParams(position=t(self.position), direction=t(self.direction),
                            right=t(right), up=t(up2),
                            focal_distance=t(self.focal_distance),
                            lens_radius=t(self.lens_radius))

    def pose_key(self):
        """Hashable pose for accumulation-reset detection."""
        return (tuple(np.round(self.position, 6).tolist()),
                round(self.horizontal_angle, 9), round(self.vertical_angle, 9),
                round(self.focal_distance, 9), round(self.lens_radius, 9))
