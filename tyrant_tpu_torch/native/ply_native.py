"""ctypes binding of the C++ PLY loader (``ply_loader.cpp``)."""

from __future__ import annotations

import ctypes

import numpy as np

from . import get_lib

_configured = False


def _configure(lib):
    global _configured
    if _configured:
        return
    lib.tyrant_ply_load.restype = ctypes.c_int
    lib.tyrant_ply_load.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
        ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.POINTER(ctypes.c_int32)),
        ctypes.POINTER(ctypes.c_int)]
    lib.tyrant_free.restype = None
    lib.tyrant_free.argtypes = [ctypes.c_void_p]
    _configured = True


def load_ply(path: str):
    """Returns (vertices [V,3] float32, faces [F,3] int32)."""
    lib = get_lib()
    _configure(lib)
    vp = ctypes.POINTER(ctypes.c_float)()
    fp = ctypes.POINTER(ctypes.c_int32)()
    nv = ctypes.c_int()
    nf = ctypes.c_int()
    rc = lib.tyrant_ply_load(path.encode(), ctypes.byref(vp), ctypes.byref(nv),
                             ctypes.byref(fp), ctypes.byref(nf))
    if rc != 0:
        raise ValueError(f"tyrant_ply_load({path}) failed with code {rc}")
    try:
        verts = np.ctypeslib.as_array(vp, (nv.value, 3)).copy()
        faces = np.ctypeslib.as_array(fp, (nf.value, 3)).copy()
    finally:
        lib.tyrant_free(vp)
        lib.tyrant_free(fp)
    return verts.astype(np.float32), faces.astype(np.int32)
