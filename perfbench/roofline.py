"""The yardstick's peaks and the kernels' counts of work.

Peaks: NVIDIA's H100 SXM data sheet, dense, without sparsity, at the full
700 W power limit: 3.35 TB/s of HBM3 and 67 TFLOP/s of float32 outside the
tensor cores (every kernel of the program computes in float32).  A card
set below 700 W runs slower under load, so every share is stated against
these peaks with the card's power limit beside it (:func:`power_limit`).

A kernel's least time is the larger of its bytes over the HBM rate and its
operations over the float32 rate.  The counts below are of the work the
inputs need, whatever implements it, so a better BVH, a new table layout
or a different kernel cannot move its own yardstick:

- traversal (``csrc/traverse.cu`` and its wave generation), per step: each
  extend-queue ray read once (origin, direction and t_max: 7 float32,
  28 B) and its hit written once (t and id: 8 B); each valid shadow ray
  read once (28 B) and its occlusion flag written once (1 B); the scene's
  triangles (three float32 vertices, 36 B) read once per queue.  Which
  rows or triangles a walk visits is left out: that depends on the BVH.
  Operations: one ray-triangle test (the Möller-Trumbore of the hit, 45
  float32 operations) for each ray, the least a closest hit can verify;
  the bytes bound it by far.
"""

from __future__ import annotations

import subprocess

HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

RAY_BYTES = 28       # origin, direction, t_max: 7 float32
HIT_BYTES = 8        # t (float32) and id (int32)
FLAG_BYTES = 1       # an occlusion flag
TRIANGLE_BYTES = 36  # three float32 vertices
RAY_TRIANGLE_OPS = 45


def least_seconds(n_bytes: float, n_ops: float) -> float:
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / FP32_OPS_PER_S)


def traversal_work(queue_rays: int, shadow_rays: float,
                   triangles: int) -> tuple[float, float]:
    """(bytes, operations) of one step's traversal: the extend queue of
    ``queue_rays`` rays, ``shadow_rays`` valid shadow rays (a step's mean
    may be fractional), over ``triangles`` triangles."""
    n_bytes = queue_rays * (RAY_BYTES + HIT_BYTES) \
        + shadow_rays * (RAY_BYTES + FLAG_BYTES) \
        + 2 * triangles * TRIANGLE_BYTES
    n_ops = (queue_rays + shadow_rays) * RAY_TRIANGLE_OPS
    return float(n_bytes), float(n_ops)


def power_limit() -> str | None:
    """The card's name and power limit as ``nvidia-smi`` reads them, or
    None where it cannot be read."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        and out.stdout.strip() else None
