"""ctypes binding of the C++ BVH builder (``bvh_builder.cpp``).

Produces the same :class:`tyrant_tpu_torch.scene.bvh.BVHArrays` as the
numpy builder (tests/test_torch_scene.py).
"""

from __future__ import annotations

import ctypes

import numpy as np

from ..config import BVHConfig
from ..scene.bvh import BVHArrays
from . import get_lib

_f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
_i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_configured = False


def _configure(lib):
    global _configured
    if _configured:
        return
    lib.tyrant_build_bvh.restype = ctypes.c_int
    lib.tyrant_build_bvh.argtypes = [
        _f32p, _f32p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_float, ctypes.c_int,
        _f32p, _f32p, _i32p, _i32p, _i32p]
    lib.tyrant_thread_links.restype = ctypes.c_int
    lib.tyrant_thread_links.argtypes = [_i32p, _i32p, ctypes.c_int,
                                        _i32p, _i32p]
    _configured = True


def build_bvh(tri_lo: np.ndarray, tri_hi: np.ndarray,
              cfg: BVHConfig = BVHConfig(),
              method: str = "sah") -> BVHArrays:
    lib = get_lib()
    _configure(lib)

    tri_lo = np.ascontiguousarray(tri_lo, np.float32)
    tri_hi = np.ascontiguousarray(tri_hi, np.float32)
    n = tri_lo.shape[0]
    if n <= 0:
        raise ValueError("empty scene")
    cap = 2 * n
    lo = np.empty((cap, 3), np.float32)
    hi = np.empty((cap, 3), np.float32)
    meta = np.empty(cap, np.int32)
    second = np.empty(cap, np.int32)
    perm = np.empty(n, np.int32)

    n_nodes = lib.tyrant_build_bvh(
        tri_lo, tri_hi, n, cfg.bucket_number, cfg.max_prims_per_leaf,
        ctypes.c_float(cfg.traversal_cost),
        ctypes.c_float(cfg.intersection_cost),
        1 if method == "sah" else 0,
        lo, hi, meta, second, perm)
    if n_nodes < 0:
        raise RuntimeError("tyrant_build_bvh failed")

    lo = lo[:n_nodes].copy()
    hi = hi[:n_nodes].copy()
    meta = meta[:n_nodes].copy()
    second = second[:n_nodes].copy()

    hit_link = np.empty((2, n_nodes), np.int32)
    miss_link = np.empty((8, n_nodes), np.int32)
    lib.tyrant_thread_links(meta, second, n_nodes,
                            hit_link.reshape(-1), miss_link.reshape(-1))
    return BVHArrays(lo=lo, hi=hi, meta=meta, second_child=second,
                     hit_link=hit_link, miss_link=miss_link, perm=perm,
                     n_nodes=int(n_nodes))
