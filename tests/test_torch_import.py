"""The PyTorch port stands alone: it imports neither JAX nor anything of the
JAX package, builds nothing at import, and runs on the card by default."""

import ast
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

_ROOT = Path(__file__).resolve().parents[1]


def _port_modules():
    import tyrant_tpu_torch
    return ["tyrant_tpu_torch"] + [
        m.name for m in pkgutil.walk_packages(tyrant_tpu_torch.__path__,
                                              "tyrant_tpu_torch.")]


def test_module_list_covers_the_package():
    files = {p.relative_to(_ROOT).with_suffix("").as_posix().replace("/", ".")
             for p in (_ROOT / "tyrant_tpu_torch").rglob("*.py")}
    files = {f[:-len(".__init__")] if f.endswith(".__init__") else f
             for f in files}
    assert files == set(_port_modules())


def test_import_leaves_jax_out():
    code = ("import sys\n"
            + "".join(f"import {m}\n" for m in _port_modules()
                      + ["chip_smoke", "bench_torch"])
            + "bad = sorted(m for m in sys.modules if m in ('jax', 'triton', "
              "'tyrant_tpu') or m.startswith(('jax.', 'tyrant_tpu.')))\n"
              "assert not bad, bad\n"
              "import tyrant_tpu_torch.ops.kernels.build as b\n"
              "import tyrant_tpu_torch.native as nat\n"
              "assert b._lib is None and nat._lib is None\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=_ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def _imported_roots(path: Path) -> list[str]:
    tree = ast.parse(path.read_text())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names]
    names += [n.module for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.level == 0]
    return [m.split(".")[0] for m in names]


def test_no_source_imports_jax_or_the_jax_package():
    paths = sorted((_ROOT / "tyrant_tpu_torch").rglob("*.py"))
    paths += [_ROOT / "chip_smoke.py", _ROOT / "bench_torch.py",
              *sorted((_ROOT / "examples").glob("*_torch.py"))]
    bad = {str(p.relative_to(_ROOT)): m for p in paths
           for m in _imported_roots(p) if m in ("jax", "tyrant_tpu")}
    assert not bad, bad


def test_chip_smoke_imports_only_the_port():
    roots = _imported_roots(_ROOT / "chip_smoke.py")
    assert "tyrant_tpu_torch" in roots
    assert not {"jax", "tyrant_tpu"} & set(roots)
    # without a card it fails before printing any result
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=_ROOT,
                          capture_output=True, text=True, timeout=120,
                          env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0
    assert proc.stdout == ""


def test_renderer_refuses_missing_cuda(monkeypatch):
    from tyrant_tpu_torch.config import small_config
    from tyrant_tpu_torch.render import Renderer
    from tyrant_tpu_torch.scene.scene import Scene

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = small_config(16, 16, 1024)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Renderer(Scene.load(None), cfg, device="cuda")
    # the card is the default: no device means CUDA, and no CPU fallback
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Renderer(Scene.load(None), cfg)
