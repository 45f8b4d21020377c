"""Native (C++) host code of the port: the binned-SAH BVH builder.

``bvh_builder.cpp`` is compiled with g++ at first use into
``build/tyrant_tpu_torch/`` at the root of the checkout (never next to the
sources), named by a hash of the source and the flags, and loaded with
ctypes.  Mesh files are not loaded by the port, so there is no PLY
loader here.
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
_SOURCE = _DIR / "bvh_builder.cpp"
BUILD_DIR = _DIR.parents[1] / "build" / "tyrant_tpu_torch"
# no -march=native and no FMA contraction: the SAH costs round as in the
# numpy builder, so both pick the same splits
GXX_FLAGS = ["-O3", "-std=c++17", "-ffp-contract=off", "-shared", "-fPIC"]

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def library_path() -> Path:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(_SOURCE.read_bytes())
    return BUILD_DIR / f"libtyrant_bvh_{h.hexdigest()[:16]}.so"


def _compile(out: Path) -> None:
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    try:
        subprocess.run(["g++", *GXX_FLAGS, "-o", tmp, str(_SOURCE)],
                       check=True, capture_output=True)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def get_lib() -> ctypes.CDLL:
    """The builder library, compiled on first use.  Raises OSError or
    CalledProcessError when g++ is missing or fails."""
    global _lib
    with _lock:
        if _lib is None:
            path = library_path()
            if not path.exists():
                _compile(path)
            _lib = ctypes.CDLL(str(path))
        return _lib
