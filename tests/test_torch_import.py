"""The PyTorch port imports without JAX and builds nothing at import."""

import ast
import os
import subprocess
import sys

import pytest
import torch

_ROOT = __file__.rsplit("/tests/", 1)[0]

_MODULES = ["tyrant_tpu_torch", "tyrant_tpu_torch.render",
            "tyrant_tpu_torch.interop", "tyrant_tpu_torch.bench.poses",
            "tyrant_tpu_torch.config", "tyrant_tpu_torch.scene.procgen",
            "chip_smoke",
            "tyrant_tpu_torch.ops.kernels.traverse",
            "tyrant_tpu_torch.ops.kernels.accum",
            "tyrant_tpu_torch.ops.tonemap", "tyrant_tpu_torch.sky"]


def test_import_leaves_jax_out():
    code = ("import sys\n"
            + "".join(f"import {m}\n" for m in _MODULES)
            + "bad = sorted(m for m in sys.modules if m == 'jax' "
              "or m.startswith('jax.') or m == 'triton')\n"
              "assert not bad, bad\n"
              "import tyrant_tpu_torch.ops.kernels.build as b\n"
              "assert b._lib is None\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=_ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_chip_smoke_imports_only_the_port():
    with open(f"{_ROOT}/chip_smoke.py") as f:
        tree = ast.parse(f.read())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names]
    names += [n.module for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom)]
    bad = [m for m in names if m.split(".")[0] in ("jax", "tyrant_tpu")]
    assert not bad, bad
    # without a card it fails before printing any result
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=_ROOT,
                          capture_output=True, text=True, timeout=120,
                          env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0
    assert proc.stdout == ""


def test_renderer_refuses_missing_cuda(monkeypatch):
    from tyrant_tpu.config import small_config
    from tyrant_tpu_torch.render import Renderer
    from tyrant_tpu_torch.scene.scene import Scene

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Renderer(Scene.load(None), small_config(16, 16, 1024), device="cuda")
