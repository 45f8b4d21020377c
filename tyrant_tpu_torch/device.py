"""Device helpers.  Entry points that take a device default to "cuda";
CUDA is checked for where it is asked for, and nothing falls back to the
CPU."""

from __future__ import annotations

import functools

import torch


def require_cuda() -> None:
    """Raise unless a CUDA device is usable."""
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: this needs an NVIDIA GPU "
                           "and a CUDA build of PyTorch")


def resolve(device) -> torch.device:
    """``device`` as a torch.device; a CUDA device must exist."""
    dev = torch.device(device)
    if dev.type == "cuda":
        require_cuda()
    return dev


@functools.lru_cache(maxsize=None)
def constant(values: tuple, device: torch.device,
             dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """A constant tensor of ``values``, made once per device and dtype and
    kept: a step that reads it copies nothing from the host, which a
    captured CUDA graph could not do.  Never write into it."""
    return torch.tensor(values, dtype=dtype, device=device)
