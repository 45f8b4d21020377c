"""Build the package's CUDA sources (``tyrant_tpu_torch/csrc/*.cu``) with
nvcc into one shared library with a plain C interface, and load it with
ctypes.  Each source compiles in its own nvcc process, all started
together, and one more nvcc links the objects.

The library lands in ``build/tyrant_tpu_torch/`` at the root of the
checkout, named by a hash of the sources and the flags, so an edited
source rebuilds and an unchanged one loads at once; beside it, a ``.log``
holds ptxas's resource usage of every kernel (``--resource-usage``), which
:func:`registers` reads.  Nothing is built at import time: the first
kernel launch builds.  A missing or failing nvcc raises with nvcc's own
error output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "tyrant_tpu_torch"
# --fmad=false: no a*b+c contraction, so Möller-Trumbore rounds like the
# eager PyTorch plain version.  Never --use_fast_math (approximate division,
# flushed denormals).
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xcompiler", "-fPIC"]
COMPILE_FLAGS = ["--resource-usage"]  # each source's compile only

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
build_seconds: float | None = None  # wall time of the last nvcc run


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (looked on PATH and in CUDA_HOME, "
                       "CUDA_PATH, /usr/local/cuda): the CUDA kernels of "
                       "tyrant_tpu_torch cannot be built")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS + COMPILE_FLAGS).encode())
    for src in _sources() + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libtyrant_kernels_{h.hexdigest()[:16]}.so"


def _run_all(cmds: list[list[str]]) -> str:
    """Run the commands side by side; raise with the first failure's
    output, else return their output (stdout and stderr) in order."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for c in cmds]
    outs = [p.communicate() for p in procs]
    for cmd, p, (out, err) in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}):\n"
                               f"{' '.join(cmd)}\n{err}{out}")
    return "".join(out + err for out, err in outs)


def _compile(out: Path) -> None:
    global build_seconds
    out.parent.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        objs = [str(Path(tmp) / f"{src.stem}.o") for src in _sources()]
        usage = _run_all([[nvcc, *NVCC_FLAGS, *COMPILE_FLAGS, "-c", "-o",
                           obj, str(src)]
                          for src, obj in zip(_sources(), objs)])
        lib = str(Path(tmp) / out.name)
        _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", lib, *objs]])
        out.with_suffix(".log").write_text(usage)
        os.replace(lib, out)
    build_seconds = time.perf_counter() - t0


def _kernel_name(mangled: str) -> str:
    """A kernel's readable name from its mangled one: the innermost name
    and its bool and int template arguments, as in
    ``traverse_kernel<true,false>`` or ``accum_kernel<3,true>``."""
    s = mangled[3:] if mangled.startswith("_ZN") else mangled[2:]
    name = mangled
    while (m := re.match(r"\d+", s)):
        k = int(m.group())
        name, s = s[m.end():m.end() + k], s[m.end() + k:]
    args = re.match(r"I((?:L[bi]\d+E)+)E", s)
    if not args:
        return name
    vals = [v if t == "i" else ("true" if v == "1" else "false")
            for t, v in re.findall(r"L([bi])(\d+)E", args.group(1))]
    return f"{name}<{','.join(vals)}>"


def registers(path: Path | None = None) -> dict[str, dict]:
    """{kernel: {"registers": a thread, "spill_stores": bytes,
    "spill_loads": bytes}} from the build log of the library at ``path``
    (default: this checkout's), as ptxas reports them under
    ``--resource-usage`` (spills where it reports them); empty when the
    log is missing."""
    log_path = (path or library_path()).with_suffix(".log")
    if not log_path.exists():
        return {}
    out, current = {}, None
    for line in log_path.read_text().splitlines():
        fn = re.search(r"entry function '(\S+)'", line) \
            or re.search(r"Function (\S+?):?\s*$", line)
        if fn and "properties" not in line:
            current = out.setdefault(_kernel_name(fn.group(1)), {})
            continue
        if current is None:
            continue
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
        if spill:
            current["spill_stores"] = int(spill.group(1))
            current["spill_loads"] = int(spill.group(2))
        reg = re.search(r"REG:(\d+)", line) \
            or re.search(r"Used (\d+) registers", line)
        if reg:
            current["registers"] = int(reg.group(1))
    return out


def load() -> ctypes.CDLL:
    """The kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            path = library_path()
            if not path.exists():
                _compile(path)
            lib = ctypes.CDLL(str(path))
            _declare(lib)
            _lib = lib
        return _lib


def _declare(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    for fn in (lib.tyrant_traverse, lib.tyrant_traverse_wave):
        fn.argtypes = [p, i, p, p, p, p, p, p, p, i, i, p]
        fn.restype = i
    lib.tyrant_accumulate.argtypes = [p, p, p, i, i, i, p, p]
    lib.tyrant_accumulate.restype = i
    lib.tyrant_stream.argtypes = [p, i, p, p, p, p, p, p, i, p, p, p, i, p,
                                  i, p, p, p]
    lib.tyrant_stream.restype = i
    lib.tyrant_shade.argtypes = [p] * 29
    lib.tyrant_shade.restype = i
    lib.tyrant_shade_surface.argtypes = [p] * 17
    lib.tyrant_shade_surface.restype = i
    lib.tyrant_shade_textured.argtypes = [p] * 14 + [i] + [p] * 13
    lib.tyrant_shade_textured.restype = i
    f = ctypes.c_float
    lib.tyrant_spheres_closest.argtypes = [p, p, p, p, i, i, f, f, p, p, p]
    lib.tyrant_spheres_closest.restype = i
    lib.tyrant_spheres_any.argtypes = [p, p, p, p, i, i, f, p, p, p, p, p]
    lib.tyrant_spheres_any.restype = i
    lib.tyrant_trace_marker.argtypes = [i, p, p, i, i, i, i, p]
    lib.tyrant_trace_marker.restype = i
    lib.tyrant_trace_count.argtypes = [p, p, p, p, i, i, p]
    lib.tyrant_trace_count.restype = i
    lib.tyrant_error_string.argtypes = [i]
    lib.tyrant_error_string.restype = ctypes.c_char_p


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise when a launch returned a CUDA error."""
    if err != 0:
        msg = lib.tyrant_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def launch(entry: str, device, *args) -> None:
    """Call the library's C entry point ``entry`` with ``args`` and the
    current stream of ``device``, and raise on a CUDA error."""
    lib = load()
    err = getattr(lib, entry)(*args,
                              torch.cuda.current_stream(device).cuda_stream)
    check(lib, err, f"{entry} launch")
