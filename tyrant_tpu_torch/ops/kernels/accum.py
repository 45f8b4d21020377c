"""Framebuffer accumulation of pixel-sorted updates with the CUDA kernel
``csrc/accum.cu``, the port of ``tyrant_tpu/ops/pallas/accum_kernel.py``.

``accumulate_sorted`` keeps the JAX contract, but updates ``accum`` IN
PLACE (the JAX function returns a new buffer) and returns it.  Entries at
or above P (the surviving rays of a step, keyed from ``sentinel(P)`` up)
are ignored.  ``accumulate_terminated`` is the render step's call: the
same kernel fed straight from the step's sort, the sorted key and the
pending radiance, with the path count of 1 implied, and with
``moment2`` the squared radiance and the count into a second buffer in
the same launch (the JAX step's second ``accumulate_sorted`` call for
adaptive sampling and ``track_variance``).  Unlike the TPU kernel, the
update values are added in float32 without a bf16 rounding, in sorted
order, so the CUDA kernel equals a sequential scatter bit for bit.
"""

from __future__ import annotations

import torch

from . import build

TILE_PIX = 2048  # the JAX kernel's tile; sets the sentinel value

# kernel launches since the last reset, without and with the moment2 mode;
# plain-version calls are not counted
launches = 0
launches_moment2 = 0


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


def terminated_updates(key, pend, p: int):
    """(upd_pix [N] i32, upd_vals [N, 4] f32) of a step's sorted key and
    pending radiance for a [P, 4] buffer: the key clamped to the sentinel,
    and (pend, 1) where the key is below it, zeros elsewhere."""
    sent = sentinel(p)
    term = key < sent
    vals = torch.where(term[:, None],
                       torch.cat([pend, torch.ones_like(pend[:, :1])], dim=1),
                       torch.zeros((key.shape[0], 4), dtype=pend.dtype,
                                   device=pend.device))
    return torch.clamp(key, max=sent).contiguous(), vals.contiguous()


def moment2_updates(key, pend, p: int):
    """(upd_pix, upd_sq): the second-moment flush's updates, (pend *
    pend, 1) in float32 where the key is below the sentinel."""
    return terminated_updates(key, pend * pend, p)


def accumulate_terminated(accum, key, pend, moment2=None):
    """accum [P, 4] f32 += (pend, 1) of every entry whose key is below P,
    in place: the accumulate stage of a render step, fed straight from its
    sort.  key: [N] i32 ascending; pend: [N, 3] f32.  With ``moment2``
    ([P, 4] f32) also moment2 += (pend * pend, 1) in the same launch.
    Bit for bit ``accumulate_sorted(accum, *terminated_updates(key, pend,
    P))`` and, with ``moment2``, ``accumulate_sorted(moment2,
    *moment2_updates(key, pend, P))``, which are its plain version.
    Returns accum."""
    p, n = accum.shape[0], key.shape[0]
    args = [("key", key, torch.int32, (n,)),
            ("pend", pend, torch.float32, (n, 3))]
    if moment2 is not None:
        args.append(("moment2", moment2, torch.float32, (p, 4)))
    _check(accum, args)
    if accum.device.type == "cpu":
        if moment2 is not None:
            accumulate_plain(moment2, *moment2_updates(key, pend, p))
        return accumulate_plain(accum, *terminated_updates(key, pend, p))
    return _launch(accum, key, pend, 3, moment2)


def _check(accum, args) -> None:
    p = accum.shape[0]
    for name, x, dtype, shape in (("accum", accum, torch.float32, (p, 4)),
                                  *args):
        if x.device != accum.device:
            raise ValueError(f"{name} is on {x.device}, accum on "
                             f"{accum.device}")
        if x.dtype != dtype or tuple(x.shape) != shape \
                or not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous {dtype} of shape "
                             f"{shape}, got {x.dtype} {tuple(x.shape)}")
    if accum.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no accumulation for device {accum.device}")


def accumulate_sorted(accum, upd_pix, upd_vals):
    """accum [P, 4] f32 += pixel-sorted updates, in place.

    upd_pix: [N] i32, ascending.  upd_vals: [N, 4] f32.  Returns accum."""
    p, n = accum.shape[0], upd_pix.shape[0]
    _check(accum, (("upd_pix", upd_pix, torch.int32, (n,)),
                   ("upd_vals", upd_vals, torch.float32, (n, 4))))
    if accum.device.type == "cpu":
        return accumulate_plain(accum, upd_pix, upd_vals)
    return _launch(accum, upd_pix, upd_vals, 4)


def _launch(accum, key, vals, width: int, moment2=None):
    global launches, launches_moment2
    lib = build.load()
    stream = torch.cuda.current_stream(accum.device).cuda_stream
    err = lib.tyrant_accumulate(accum.data_ptr(), key.data_ptr(),
                                vals.data_ptr(), key.shape[0], accum.shape[0],
                                width, None if moment2 is None
                                else moment2.data_ptr(), stream)
    build.check(lib, err, "tyrant_accumulate launch")
    if moment2 is None:
        launches += 1
    else:
        launches_moment2 += 1
    return accum
