"""Breadth-first closest hit with the CUDA kernel ``csrc/stream.cu``, the
port of ``tyrant_tpu/ops/pallas/stream_kernel.py`` (``_level_kernel``,
driven by ``_stream_impl`` and ``closest_hit_stream``).

:func:`closest_hit_stream` keeps the JAX contract: (t, id) with id -1
where nothing beat t_init, ``cap_mult`` sizing the frontier, and a frontier
overflow raising after one host read of the flag unless the caller takes
the flag with ``return_overflow=True``.  On CUDA tensors it launches the
kernel, one launch per tree level with no host sync between them; on CPU
tensors it runs the plain version, :mod:`tyrant_tpu_torch.ops.stream`.
Both give the same t bit for bit and the same ids; against the depth-first
walk they agree up to epsilon ties.

Differences from the JAX function, by design: no hit queue (hits are
min-combined per ray as they are found), so no hit-queue overflow; int32
pair fields, so no 2^24 capacity bound; no cut at 64 levels (the tree's
depth bounds the levels).
"""

from __future__ import annotations

import torch

from ...config import VERY_FAR
from .. import stream as plain
from . import build
from .traverse import PacketTables, _check_rays

# level-kernel launches since the last reset; plain-version calls are not
# counted
launches = 0


def _launch(origin, direction, t_init, tables: PacketTables, cap: int,
            stats: dict | None):
    global launches
    rows = tables.rows
    if not rows.is_contiguous():
        raise ValueError("the fat-row table must be contiguous")
    n, dev = origin.shape[0], origin.device
    levels = tables.max_depth
    t_out = torch.empty_like(t_init)
    hit = torch.empty((n,), dtype=torch.int32, device=dev)
    pair_ray = torch.empty((2 * cap,), dtype=torch.int32, device=dev)
    pair_row = torch.empty_like(pair_ray)
    pair_t = torch.empty((2 * cap,), dtype=torch.float32, device=dev)
    counts = torch.zeros((levels + 1,), dtype=torch.int32, device=dev)
    best = torch.empty((n,), dtype=torch.int64, device=dev)
    ovf = torch.zeros((1,), dtype=torch.int32, device=dev)
    lib = build.load()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.tyrant_stream(rows.data_ptr(), rows.shape[0], origin.data_ptr(),
                            direction.data_ptr(), t_init.data_ptr(),
                            t_out.data_ptr(), hit.data_ptr(), n,
                            pair_ray.data_ptr(), pair_row.data_ptr(),
                            pair_t.data_ptr(), cap, counts.data_ptr(), levels,
                            best.data_ptr(), ovf.data_ptr(), stream)
    build.check(lib, err, "tyrant_stream launch")
    launches += levels
    if stats is not None:
        asked = [c for c in counts.tolist() if c > 0]
        stats.update(pairs=asked, levels=len(asked))
    return t_out, hit, ovf[0]


def closest_hit_stream(origin, direction, tables: PacketTables, t_init=None,
                       cap_mult: int = 3, return_overflow: bool = False,
                       stats: dict | None = None):
    """Closest hit, breadth first.  origin/direction [N, 3] f32; t_init
    optional [N] f32.  Returns (t [N], leaf-order prim id [N] i32), with t
    == t_init and id -1 where nothing beats t_init, and with
    ``return_overflow`` the overflow flag (0-dim i32 tensor) third.

    ``cap_mult``: a frontier level holds ``cap_mult`` times the ray count
    (padded as the JAX kernel pads it).  Past it, pairs are dropped and
    the flag is set; without ``return_overflow`` that raises RuntimeError.
    ``stats``: a dict that receives "pairs" (the pairs each level asked
    for) and "levels"; the plain version also counts "box_tests" and
    "tri_tests"."""
    n = origin.shape[0]
    if t_init is None:
        t_init = torch.full((n,), VERY_FAR, dtype=torch.float32,
                            device=origin.device)
    _check_rays(origin, direction, t_init, tables)
    if cap_mult < 1:
        raise ValueError(f"cap_mult must be at least 1, got {cap_mult}")
    cap = plain.capacity(n, cap_mult)
    if 2 * cap >= 2 ** 31:
        raise ValueError(f"cap_mult={cap_mult} x {n} rays: {cap} pairs a "
                         "level is past the kernel's int32 counts")
    if origin.device.type == "cpu":
        t, hit, ovf = plain.closest_hit_stream(
            origin, direction, tables.rows, tables.max_depth, t_init,
            cap_mult, stats=stats)
    elif origin.device.type == "cuda":
        t, hit, ovf = _launch(origin, direction, t_init, tables, cap, stats)
    else:
        raise ValueError(f"no traversal for device {origin.device}")
    if return_overflow:
        return t, hit, ovf
    if int(ovf) != 0:
        raise RuntimeError(
            f"stream traversal frontier overflow at cap_mult={cap_mult}: "
            "pairs were dropped and the closest hits are incomplete.  Re-run "
            "with a larger cap_mult or pass return_overflow=True to handle "
            "the flag yourself.")
    return t, hit
