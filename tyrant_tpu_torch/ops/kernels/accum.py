"""Framebuffer accumulation of pixel-sorted updates with the CUDA kernel
``csrc/accum.cu``, the port of ``tyrant_tpu/ops/pallas/accum_kernel.py``.

``accumulate_sorted`` updates ``accum`` IN PLACE (the JAX function returns
a new buffer) and returns it.  Entries at or above ``sentinel(P)`` (the
surviving rays of a step) are ignored.  Unlike the TPU kernel, the update
values are added in float32 without a bf16 rounding, in sorted order, so
the CUDA kernel equals a sequential scatter.
"""

from __future__ import annotations

import torch

from . import build

TILE_PIX = 2048  # the JAX kernel's tile; sets the sentinel value

# kernel launches since the last reset; plain-version calls are not counted
launches = 0


def sentinel(p: int) -> int:
    """Pixel value ignored by accumulate_sorted for a [P, 4] buffer: P
    rounded up to a whole tile, as in the JAX package, so sort keys match
    it value for value."""
    return -(-p // TILE_PIX) * TILE_PIX


def accumulate_plain(accum, upd_pix, upd_vals):
    """The plain version: an index_add_ of the entries below P (in index
    order on the CPU, so it adds in sorted order there)."""
    keep = upd_pix < accum.shape[0]
    accum.index_add_(0, upd_pix[keep].to(torch.int64), upd_vals[keep])
    return accum


def accumulate_sorted(accum, upd_pix, upd_vals):
    """accum [P, 4] f32 += pixel-sorted updates, in place.

    upd_pix: [N] i32, ascending.  upd_vals: [N, 4] f32.  Returns accum."""
    p, n = accum.shape[0], upd_pix.shape[0]
    for name, x, dtype, shape in (("accum", accum, torch.float32, (p, 4)),
                                  ("upd_pix", upd_pix, torch.int32, (n,)),
                                  ("upd_vals", upd_vals, torch.float32, (n, 4))):
        if x.device != accum.device:
            raise ValueError(f"{name} is on {x.device}, accum on {accum.device}")
        if x.dtype != dtype or tuple(x.shape) != shape or not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous {dtype} of shape "
                             f"{shape}, got {x.dtype} {tuple(x.shape)}")
    if accum.device.type == "cpu":
        return accumulate_plain(accum, upd_pix, upd_vals)
    if accum.device.type != "cuda":
        raise ValueError(f"no accumulation for device {accum.device}")
    global launches
    lib = build.load()
    stream = torch.cuda.current_stream(accum.device).cuda_stream
    err = lib.tyrant_accumulate(accum.data_ptr(), upd_pix.data_ptr(),
                                upd_vals.data_ptr(), n, p, stream)
    build.check(lib, err, "tyrant_accumulate launch")
    launches += 1
    return accum
