"""Adaptive sampling, the port of ``tyrant_tpu/adaptive.py``.

With ``RenderConfig.adaptive_sampling="on"`` the step's flush also adds
each finished path's squared radiance into ``RenderState.moment2`` (the
same pixel-sorted launch of ``csrc/accum.cu``), and every
``adaptive_interval`` steps the Renderer rebuilds the raygen visit order
``pixel_perm`` from the per-pixel relative standard error: pixel i gets
visit slots in proportion to (err_i + floor)^gamma, as the inverse CDF of
the weights at P equispaced points (so the order is monotonic in pixel
id), shifted between rebuilds by a golden-ratio phase.  The per-pixel
mean (radiance sum / path count) is unbiased under any visit order.

:func:`build_perm` runs in three stages that a test can feed one by one:
:func:`perm_weights` (the weights), :func:`quantize_weights` (the integer
weights ``wq``, quantised by the float32 sum of the weights) and
:func:`perm_from_wq` (the perm).  The float32 sum is a reduction whose
order is the framework's own, so an entry of ``wq`` can differ by 1 from
the JAX package's; fed the same ``wq``, the perm is equal to the JAX
package's.  Nothing here reads a device value on the host.
"""

from __future__ import annotations

import torch

from .device import constant

# error floor added to the mean luminance (near-black pixels would
# otherwise rank first on a tiny absolute noise)
_LUM_FLOOR = 0.05
# minimum weight as a fraction of the mean error: every pixel keeps ~20%
# of a uniform share
_WEIGHT_FLOOR = 0.25
_LUM = (0.299, 0.587, 0.114)


def _relative_error(accum: torch.Tensor, moment2: torch.Tensor):
    """(relative standard error of each pixel's mean [P], path counts [P],
    max(count, 1) [P]) from the first and second moments."""
    cnt = accum[:, 3]
    n = torch.clamp(cnt, min=1.0)
    mean = accum[:, :3] / n[:, None]
    m2 = moment2[:, :3] / n[:, None]
    var = torch.clamp(m2 - mean * mean, min=0.0).sum(dim=1)
    lum = mean @ constant(_LUM, accum.device)
    return torch.sqrt(var / n) / (lum + _LUM_FLOOR), cnt, n


def perm_weights(accum: torch.Tensor, moment2: torch.Tensor,
                 gamma: float = 1.0) -> torch.Tensor:
    """The visit weights [P]: the relative error (unsampled pixels take
    the largest observed one), inflated at low counts by the mean error
    over sqrt(n) (a pixel whose few samples happened to agree is not
    starved), plus the floor, to the power ``gamma``."""
    err, cnt, n = _relative_error(accum, moment2)
    emax = torch.where(cnt >= 1.0, err, torch.zeros_like(err)).max()
    err = torch.where(cnt < 1.0, torch.clamp(emax, min=1e-6), err)
    ebar = err.mean() + 1e-12
    err = err + ebar * torch.rsqrt(n)
    return torch.pow(err + _WEIGHT_FLOOR * ebar, gamma)


def quantize_weights(w: torch.Tensor) -> torch.Tensor:
    """Integer weights [P] i32, about 16 times the average and at least
    1, so that their cumulative sum is exact (a float32 one has an ulp of
    ~0.25 near its end at 1080p)."""
    p = w.shape[0]
    return torch.clamp((w * (16.0 * p / (w.sum() + 1e-30))).to(torch.int32),
                       min=1)


def perm_from_wq(wq: torch.Tensor, phase: torch.Tensor) -> torch.Tensor:
    """The visit schedule [P] i32 (with repetition, ascending) from the
    integer weights: the inverse of their CDF at (i + phase) * stride;
    ``phase`` a float32 tensor in [0, 1) on wq's device."""
    p = wq.shape[0]
    cdf = torch.cumsum(wq, 0, dtype=torch.int32)
    stride = cdf[-1].to(torch.float32) / p
    targets = ((torch.arange(p, dtype=torch.float32, device=wq.device)
                + phase.to(torch.float32)) * stride).to(torch.int32)
    perm = torch.searchsorted(cdf, targets, right=True)
    return torch.clamp(perm, 0, p - 1).to(torch.int32)


def build_perm(accum: torch.Tensor, moment2: torch.Tensor,
               phase: torch.Tensor, gamma: float = 1.0) -> torch.Tensor:
    """accum, moment2 [P, 4] -> the visit schedule [P] i32."""
    return perm_from_wq(quantize_weights(perm_weights(accum, moment2,
                                                      gamma)), phase)


def mean_relative_error(accum: torch.Tensor,
                        moment2: torch.Tensor) -> torch.Tensor:
    """The image's convergence: the mean relative standard error over the
    pixels with at least two paths (a 0-d tensor)."""
    err, cnt, _ = _relative_error(accum, moment2)
    sampled = (cnt >= 2.0).to(torch.float32)
    return (err * sampled).sum() / torch.clamp(sampled.sum(), min=1.0)


def identity_perm(p: int, device) -> torch.Tensor:
    return torch.arange(p, dtype=torch.int32, device=device)


class PermScheduler:
    """The rebuilds' bookkeeping on the host: after every ``interval``
    rendered steps, the golden-ratio phase of the next build_perm."""

    def __init__(self, interval: int):
        self.interval = interval
        self.steps = 0
        self.rebuilds = 0

    def tick(self, n_steps: int):
        """Advance by ``n_steps``; returns the rebuild's phase, or None."""
        self.steps += n_steps
        if self.steps < self.interval:
            return None
        self.steps = 0
        self.rebuilds += 1
        return (self.rebuilds * 0.6180339887) % 1.0
