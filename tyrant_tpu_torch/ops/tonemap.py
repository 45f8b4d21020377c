"""Tone mapping and framebuffer resolve, the port of
``tyrant_tpu/ops/tonemap.py`` (``resolve``, ``tonemap_image``,
``to_uint8``)."""

from __future__ import annotations

import torch


def resolve(accum: torch.Tensor, width: int, height: int,
            operator: str = "reinhard", exposure: float = 1.0) -> torch.Tensor:
    """accum [H*W, 4] (rgb radiance sum, a = completed paths) ->
    [H, W, 3] float32 in [0, 1]."""
    counts = torch.clamp(accum[:, 3:4], min=1e-8)
    cl = accum[:, :3] / counts
    return tonemap_image(cl, operator, exposure).reshape(height, width, 3)


def tonemap_image(cl: torch.Tensor, operator: str = "reinhard",
                  exposure: float = 1.0) -> torch.Tensor:
    """Linear radiance [..., 3] -> display [0, 1] (curve + gamma 1/2.2)."""
    cl = cl * exposure
    if operator == "aces":
        a, b, c, d, e = 2.51, 0.03, 2.43, 0.59, 0.14
        cl = (cl * (a * cl + b)) / (cl * (c * cl + d) + e)
    else:
        cl = cl / (cl + 1.0)
    return torch.pow(torch.clamp(cl, 0.0, 1.0), 1.0 / 2.2)


def to_uint8(img: torch.Tensor) -> torch.Tensor:
    return torch.clamp(img * 255.0 + 0.5, 0, 255).to(torch.uint8)
