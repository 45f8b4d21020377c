"""Analytic Rayleigh + Mie sun/sky, the port of ``tyrant_tpu/sky.py``: the
solar radiance for NEE (:func:`sun`), the sky alone (:func:`sky`), the sky
with its smoothstep solar disc (:func:`sunsky`), both miss radiances from
one evaluation (:func:`sky_and_sunsky`, what the render step calls) and
the UI sun position mapping (:func:`from_spherical`,
:func:`sun_direction_from_position`).  Directions are ``[..., 3]``; "up"
is +Z."""

from __future__ import annotations

import dataclasses
import functools
import math

import torch

from .config import PI, SkyConfig
from .device import constant
from .ops.sampling import dot, normalize

K = (0.686, 0.678, 0.666)
UP = (0.0, 0.0, 1.0)
RAYLEIGH_AT_X = (5.176821e-6, 1.2785348e-5, 2.8530756e-5)


@dataclasses.dataclass(frozen=True)
class SkyParams:
    """Host-side scalars of the atmosphere, computed once per config."""

    cfg: SkyConfig = dataclasses.field(default_factory=SkyConfig)

    @property
    def sun_angular_diameter_cos(self) -> float:
        return math.cos(self.cfg.sun_size_degrees * PI / 180.0)

    def total_mie(self, device) -> torch.Tensor:
        """The Mie coefficients [3], computed on ``device`` once per
        device and kept (see :func:`~tyrant_tpu_torch.device.constant`)."""
        return _total_mie(self.cfg, torch.device(device))


@functools.lru_cache(maxsize=None)
def _total_mie(cfg: SkyConfig, device: torch.device) -> torch.Tensor:
    c = (0.2 * cfg.turbidity) * 10e-18
    wl = constant(tuple(cfg.primary_wavelengths), device)
    k = constant(K, device)
    mie = 0.434 * c * PI * torch.pow((2.0 * PI) / wl, cfg.v - 2.0) * k
    return mie * cfg.mie_coefficient


def from_spherical(p):
    """Spherical (azimuth, inclination) [..., 2] -> cartesian [..., 3]."""
    return torch.stack([torch.cos(p[..., 0]) * torch.sin(p[..., 1]),
                        torch.sin(p[..., 0]) * torch.sin(p[..., 1]),
                        torch.cos(p[..., 1])], dim=-1)


def sun_direction_from_position(sun_position, device) -> torch.Tensor:
    """The UI's 2-D sun position as a world direction [3]."""
    pos = torch.as_tensor(sun_position, dtype=torch.float32, device=device)
    half = torch.tensor([0.0, 0.5], dtype=torch.float32, device=device)
    scale = torch.tensor([6.28, 3.14], dtype=torch.float32, device=device)
    return normalize(from_spherical((pos - half) * scale))


def _rayleigh_phase(cos_angle):
    return (3.0 / (16.0 * PI)) * (1.0 + cos_angle * cos_angle)


def _hg_phase(cos_angle, g):
    return (1.0 / (4.0 * PI)) * ((1.0 - g * g) /
                                 torch.pow(1.0 - 2.0 * g * cos_angle + g * g,
                                           1.5))


def _sun_intensity(zenith_angle_cos, cfg: SkyConfig):
    return cfg.sun_intensity * torch.clamp(
        1.0 - torch.exp(-((cfg.cutoff_angle
                           - torch.arccos(torch.clamp(zenith_angle_cos,
                                                      -1.0, 1.0)))
                          / cfg.steepness)), min=0.0)


def _atmosphere_common(view_dir, sun_dir, params: SkyParams):
    """Returns (sun_e, fex, sky_term, cos_view_sun)."""
    cfg = params.cfg
    dev = view_dir.device
    up = constant(UP, dev)
    cos_view_sun = dot(view_dir, sun_dir)
    cos_sun_up = dot(sun_dir, up)
    cos_up_view = dot(up, view_dir)

    sun_e = _sun_intensity(cos_sun_up, cfg)
    rayleigh = constant(RAYLEIGH_AT_X, dev)
    mie = params.total_mie(dev)

    zenith = torch.clamp(cos_up_view, min=0.0)
    # a zero zenith gives an infinite optical length -> Fex = 0
    rayleigh_len = cfg.rayleigh_zenith_length / zenith[..., None]
    mie_len = cfg.mie_zenith_length / zenith[..., None]

    fex = torch.exp(-(rayleigh * rayleigh_len + mie * mie_len))

    rayleigh_to_eye = rayleigh * _rayleigh_phase(cos_view_sun)[..., None]
    mie_to_eye = mie * _hg_phase(cos_view_sun, cfg.mie_directional_g)[..., None]

    light_frac = (rayleigh_to_eye + mie_to_eye) / (rayleigh + mie)
    something = sun_e[..., None] * light_frac

    sky_term = something * (1.0 - fex)
    mix_t = torch.clamp(torch.pow(1.0 - dot(up, sun_dir), 5.0), 0.0, 1.0)
    low_sun = torch.pow(torch.clamp(something * fex, min=0.0), 0.5)
    sky_term = sky_term * ((1.0 - mix_t) + mix_t * low_sun)
    return sun_e, fex, sky_term, cos_view_sun


def sun(view_dir, sun_dir, params: SkyParams):
    """Solar-disc radiance (sun NEE), with the reference's disc-test
    precedence bug fixed as in the JAX package."""
    sun_e, fex, _, cos_view_sun = _atmosphere_common(view_dir, sun_dir, params)
    sundisk = (cos_view_sun >= params.sun_angular_diameter_cos).to(torch.float32)
    return 0.01 * (sun_e[..., None] * 19000.0 * fex) * sundisk[..., None]


def sky(view_dir, sun_dir, params: SkyParams):
    """Sky-only radiance (the diffuse-born miss)."""
    _, _, sky_term, _ = _atmosphere_common(view_dir, sun_dir, params)
    return params.cfg.sky_factor * 0.01 * sky_term


def _sun_disc(sun_e, fex, cos_view_sun, params: SkyParams):
    """The smoothstep solar disc term of :func:`sunsky`."""
    a = params.sun_angular_diameter_cos
    t = torch.clamp((cos_view_sun - a) / 0.00002, 0.0, 1.0)
    sundisk = t * t * (3.0 - 2.0 * t)
    return (sun_e[..., None] * 19000.0 * fex) * sundisk[..., None] * 1e-5


def sunsky(view_dir, sun_dir, params: SkyParams):
    """Sky plus the smoothstep solar disc (the specular-born miss)."""
    sun_e, fex, sky_term, cos_view_sun = _atmosphere_common(view_dir, sun_dir,
                                                            params)
    return 0.01 * (_sun_disc(sun_e, fex, cos_view_sun, params) + sky_term)


def sky_and_sunsky(view_dir, sun_dir, params: SkyParams):
    """Both miss radiances from one atmosphere evaluation: sky() for
    diffuse-born misses and sunsky() for specular-born ones."""
    sun_e, fex, sky_term, cos_view_sun = _atmosphere_common(view_dir, sun_dir,
                                                            params)
    sky_v = params.cfg.sky_factor * 0.01 * sky_term
    return sky_v, 0.01 * (_sun_disc(sun_e, fex, cos_view_sun, params)
                          + sky_term)
