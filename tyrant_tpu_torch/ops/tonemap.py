"""Tone mapping, framebuffer resolve and display post-processing, the
port of ``tyrant_tpu/ops/tonemap.py`` (``resolve``, ``tonemap_image``,
``to_uint8``, ``bloom``, ``auto_exposure``)."""

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


def bloom(cl: torch.Tensor, strength: float = 0.08, threshold: float = 1.0,
          radius: int = 8) -> torch.Tensor:
    """Lens-glare bloom on linear radiance [H, W, 3], before the tone
    curve: the bright pass (radiance above ``threshold``), blurred by a
    separable gaussian of sigma radius/2 with reflected borders, added
    back times ``strength``.  The radius is clamped below each image side
    (a reflected border needs pad < size)."""
    bright = torch.clamp(cl - threshold, min=0.0)
    radius = max(1, min(int(radius), cl.shape[0] - 1, cl.shape[1] - 1))
    sigma = radius / 2.0
    xs = torch.arange(-radius, radius + 1, dtype=torch.float32,
                      device=cl.device)
    k = torch.exp(-0.5 * (xs / sigma) ** 2)
    k = k / k.sum()

    def blur_axis(img, axis):
        n = img.shape[axis]
        # reflect padding: padded[j] = img[reflect(j - radius)]
        src = torch.arange(-radius, n + radius, device=img.device).abs()
        src = torch.where(src >= n, 2 * (n - 1) - src, src)
        p = img.index_select(axis, src)
        out = torch.zeros_like(img)
        for i in range(2 * radius + 1):
            out = out + k[i] * p.narrow(axis, i, n)
        return out

    halo = blur_axis(blur_axis(bright, 0), 1)
    return cl + strength * halo


def auto_exposure(radiance, key: float = 0.18, eps: float = 1e-6,
                  max_gain: float = 1e4) -> float:
    """Photographic auto-exposure (Reinhard 2002, "key of the scene"): the
    scale that maps the log-average luminance of linear radiance [..., 3]
    to ``key``.  A near-black buffer (log-average below key / max_gain)
    returns 1.0, so black frames stay black."""
    r = torch.as_tensor(radiance, dtype=torch.float32)
    lum = 0.2126 * r[..., 0] + 0.7152 * r[..., 1] + 0.0722 * r[..., 2]
    log_avg = float(torch.exp(torch.mean(torch.log(lum + eps))))
    if log_avg < key / max_gain:
        return 1.0
    return float(key / log_avg)
