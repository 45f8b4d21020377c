"""Edge-aware à-trous wavelet denoiser, the port of
``tyrant_tpu/denoise.py``.

The noisy per-pixel radiance mean is smoothed by iterated 5x5
cross-bilateral passes whose footprint doubles each time (à trous, "with
holes"), edge-stopped by the noise-free guides of the AOV pass
(``render.render_aovs``: albedo, normal, depth).  Radiance is divided by
the albedo first, so only irradiance is smoothed, and multiplied back at
the end.  Every tap is a whole-image shift with edge-clamped borders:
plain element-wise PyTorch, as the JAX package leaves it to XLA outside
any Pallas kernel.

Technique: Dammertz et al., "Edge-Avoiding À-Trous Wavelet Transform for
Fast Global Illumination Filtering" (HPG 2010); the demodulation and the
feature guides follow SVGF (Schied et al. 2017).
"""

from __future__ import annotations

import torch

# B3-spline 5-tap kernel
_H = (1.0 / 16.0, 1.0 / 4.0, 3.0 / 8.0, 1.0 / 4.0, 1.0 / 16.0)


def _shift(img: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """out[y, x] = img[clamp(y - dy), clamp(x - dx)]: a whole-image shift
    with edge-clamped borders."""
    h, w = img.shape[0], img.shape[1]
    rows = torch.clamp(torch.arange(h, device=img.device) - dy, 0, h - 1)
    cols = torch.clamp(torch.arange(w, device=img.device) - dx, 0, w - 1)
    return img[rows][:, cols]


def atrous_denoise(radiance: torch.Tensor, albedo: torch.Tensor,
                   normal: torch.Tensor, depth: torch.Tensor,
                   iterations: int = 4, sigma_color: float = 0.45,
                   sigma_normal: float = 32.0,
                   sigma_depth: float = 0.02) -> torch.Tensor:
    """radiance [H, W, 3] (linear per-pixel mean) -> denoised [H, W, 3].

    albedo/normal [H, W, 3] and depth [H, W] are the AOV guides.
    sigma_color bounds the relative irradiance difference a tap may
    bridge; sigma_depth is relative to the local depth (both edge stops
    are scale-free)."""
    irr = radiance / torch.clamp(albedo, min=1e-3)
    finite_depth = torch.clamp(depth, max=1e19)
    # miss pixels carry normal 0: two sky pixels see each other with full
    # weight, sky against surface stays blocked by the dot product of 0
    sky = (normal * normal).sum(-1) < 0.25

    for it in range(iterations):
        step = 1 << it
        acc = torch.zeros_like(irr)
        wsum = torch.zeros(irr.shape[:2] + (1,), dtype=irr.dtype,
                           device=irr.device)
        for ky in range(5):
            for kx in range(5):
                dy, dx = (ky - 2) * step, (kx - 2) * step
                s_irr = _shift(irr, dy, dx)
                s_n = _shift(normal, dy, dx)
                s_d = _shift(finite_depth, dy, dx)
                # normal edge stop: cos^sigma (flat passes, creases block)
                ndot = torch.clamp((normal * s_n).sum(-1), min=0.0)
                both_sky = sky & ((s_n * s_n).sum(-1) < 0.25)
                w = _H[ky] * _H[kx] * torch.where(
                    both_sky, torch.ones_like(ndot),
                    torch.pow(ndot, sigma_normal))
                # depth edge stop, relative to the local depth
                dz = torch.abs(finite_depth - s_d) \
                    / (torch.abs(finite_depth) * sigma_depth + 1e-3)
                w = w * torch.exp(-dz)
                # colour edge stop on the running irradiance, relative
                # difference (an absolute stop collapses every weight at
                # low sample counts)
                dc = torch.abs(irr - s_irr).sum(-1) \
                    / ((torch.abs(irr) + torch.abs(s_irr)).sum(-1) + 1e-3)
                w = (w * torch.exp(-dc / sigma_color))[..., None]
                acc = acc + s_irr * w
                wsum = wsum + w
        irr = acc / torch.clamp(wsum, min=1e-8)

    return irr * torch.clamp(albedo, min=1e-3)
