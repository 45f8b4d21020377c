"""The ray-sphere test of the render step in CUDA (``csrc/spheres.cu``),
in two modes: :func:`closest`, the closest sphere hit of extend
(``render.sphere_pass``), and :func:`any_hit`, the sphere occlusion of
connect (``render._connect``) OR-ed into the traversal's occluded flags.
Their plain versions are ``ops/intersect.py``'s ``intersect_spheres`` and
``any_hit_spheres``.

The gate: CUDA tensors launch the kernel, CPU tensors take the plain
version; on any other device, and on a malformed input or an empty sphere
list (the callers skip the test without spheres), a call raises.  The
kernel launches on the current stream without a host synchronise or an
allocation of its own, so a CUDA graph can capture it, and its outputs
equal the plain version's on the card bit for bit: t and the sphere id,
or the occluded flags.  With the tracer on, each call adds its slots to
the step's ``sphere_kernel`` counter (0 where the plain version ran).
"""

from __future__ import annotations

import numpy as np
import torch

from ...config import EPSILON, VERY_FAR
from ...utils import profiling as _prof
from ..intersect import any_hit_spheres, intersect_spheres
from . import build

# kernel launches since the last reset, of each mode; plain-version calls
# are not counted
launches_closest = 0
launches_any = 0

_EPS = float(np.float32(EPSILON))  # the plain version's float32 operand
_FAR = float(np.float32(VERY_FAR))


def _check(origin, direction, centers, radii, extra=()) -> int:
    """Raise unless every input is a contiguous tensor of its dtype and
    shape on origin's device, on the CPU or CUDA, with at least one
    sphere; return the number of spheres."""
    n, s = origin.shape[0], centers.shape[0]
    dev = origin.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no sphere test for device {dev}")
    if s == 0:
        raise ValueError("an empty sphere list: the callers skip the test "
                         "without spheres")
    f32 = torch.float32
    for name, x, dtype, shape in (("origin", origin, f32, (n, 3)),
                                  ("direction", direction, f32, (n, 3)),
                                  ("centers", centers, f32, (s, 3)),
                                  ("radii", radii, f32, (s,)), *extra):
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, origin on {dev}")
        if x.dtype != dtype or tuple(x.shape) != shape \
                or not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous {dtype} of shape "
                             f"{shape}, got {x.dtype} {tuple(x.shape)}")
    return s


def _tally(n: int) -> None:
    """Add ``n`` slots to this step's ``sphere_kernel`` counter."""
    if _prof.ON:
        _prof.defer_add("sphere_kernel", n)


def closest(origin, direction, centers, radii):
    """The closest sphere hit of every ray: origin/direction [N, 3] f32,
    centers [S, 3] f32, radii [S] f32, S > 0.  Returns (t [N] f32, sphere
    id [N] i32), VERY_FAR and -1 on a miss, the lowest index of equal
    distances: ``intersect_spheres``, in one launch on CUDA tensors."""
    global launches_closest
    s = _check(origin, direction, centers, radii)
    if origin.device.type == "cpu":
        return intersect_spheres(origin, direction, centers, radii)
    n, dev = origin.shape[0], origin.device
    t = torch.empty((n,), dtype=torch.float32, device=dev)
    ident = torch.empty((n,), dtype=torch.int32, device=dev)
    build.launch("tyrant_spheres_closest", dev, origin.data_ptr(),
            direction.data_ptr(), centers.data_ptr(), radii.data_ptr(), s, n,
            _EPS, _FAR, t.data_ptr(), ident.data_ptr())
    launches_closest += 1
    _tally(n)
    return t, ident


def any_hit(origin, direction, centers, radii, occluded, max_dist, valid):
    """The shadow rays' occlusion with the spheres added: ``occluded`` [N]
    bool (the traversal's) OR, where ``valid`` [N] bool, a sphere at 0 < t
    with t + EPSILON < ``max_dist`` [N] f32 (read only where valid).
    Returns a new bool [N]: ``occluded | any_hit_spheres(...)`` with the
    max distance 0 where invalid, in one launch on CUDA tensors."""
    global launches_any
    n = origin.shape[0]
    b8 = torch.bool
    s = _check(origin, direction, centers, radii,
               (("occluded", occluded, b8, (n,)),
                ("max_dist", max_dist, torch.float32, (n,)),
                ("valid", valid, b8, (n,))))
    if origin.device.type == "cpu":
        maxd = torch.where(valid, max_dist, torch.zeros_like(max_dist))
        return occluded | any_hit_spheres(origin, direction, centers, radii,
                                          maxd)
    out = torch.empty_like(occluded)
    build.launch("tyrant_spheres_any", origin.device, origin.data_ptr(),
            direction.data_ptr(), centers.data_ptr(), radii.data_ptr(), s, n,
            _EPS, valid.data_ptr(), max_dist.data_ptr(), occluded.data_ptr(),
            out.data_ptr())
    launches_any += 1
    _tally(n)
    return out

