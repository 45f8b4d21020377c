"""Native (C++) host code of the port: the binned-SAH BVH builder and the
PLY loader.

``bvh_builder.cpp`` and ``ply_loader.cpp`` are compiled together with g++
at first use into one library in ``build/tyrant_tpu_torch/`` at the root
of the checkout (never next to the sources), named by a hash of both
sources and the flags, and loaded with ctypes.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path

_DIR = Path(__file__).resolve().parent
_SOURCES = (_DIR / "bvh_builder.cpp", _DIR / "ply_loader.cpp")
BUILD_DIR = _DIR.parents[1] / "build" / "tyrant_tpu_torch"
# no -march=native and no FMA contraction: the SAH costs round as in the
# numpy builder, so both pick the same splits
GXX_FLAGS = ["-O3", "-std=c++17", "-ffp-contract=off", "-shared", "-fPIC"]

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def library_path() -> Path:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    for src in _SOURCES:
        h.update(src.read_bytes())
    return BUILD_DIR / f"libtyrant_native_{h.hexdigest()[:16]}.so"


def _compile(out: Path) -> None:
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    try:
        subprocess.run(["g++", *GXX_FLAGS, "-o", tmp,
                        *(str(s) for s in _SOURCES)],
                       check=True, capture_output=True)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def build_library() -> str:
    """Compile the native library with g++ (again, if it exists) and
    return its path, the one :func:`get_lib` loads.  Raises OSError or
    CalledProcessError when g++ is missing or fails."""
    path = library_path()
    _compile(path)
    return str(path)


def get_lib() -> ctypes.CDLL:
    """The native library, compiled on first use.  Raises OSError or
    CalledProcessError when g++ is missing or fails."""
    global _lib
    with _lock:
        if _lib is None:
            path = library_path()
            if not path.exists():
                _compile(path)
            _lib = ctypes.CDLL(str(path))
        return _lib
