"""The run's check of loaded modules compares top-level names whole, and
nothing under ``perfbench/`` imports JAX, the JAX package or the
program's own bench and card scripts."""

import ast
import subprocess
import sys
import types

import pytest

import pb_cpu
from perfbench import run

BANNED_ROOTS = {"jax", "jaxlib", "flax", "tyrant_tpu", "bench_torch",
                "chip_smoke"}


@pytest.mark.parametrize("name,refused", [
    ("tyrant_tpu_torch", False), ("tyrant_tpu_torch.render", False),
    ("tyrant_tpu", True), ("tyrant_tpu.render", True), ("jax", True),
    ("jaxlib.xla_client", True), ("flax.linen", True),
    ("jaxtyping", False), ("tyrant_tpu_extra", False)])
def test_whole_name_check(monkeypatch, name, refused):
    for key in [m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "flax",
                                       "tyrant_tpu")]:
        monkeypatch.delitem(sys.modules, key)
    monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert (name.split(".")[0] in run.forbidden_modules()) == refused


def _imports(path):
    tree = ast.parse(path.read_text())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names]
    names += [n.module for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.level == 0 and n.module]
    return names


def test_no_source_imports_what_it_must_not():
    for path in sorted((pb_cpu.ROOT / "perfbench").rglob("*.py")):
        for name in _imports(path):
            assert name.split(".")[0] not in BANNED_ROOTS, (path, name)
            assert not name.startswith("tyrant_tpu_torch.bench"), (path, name)


def test_reference_imports_nothing_of_the_program():
    for path in (pb_cpu.ROOT / "perfbench" / "reference").rglob("*.py"):
        for name in _imports(path):
            assert name.split(".")[0] in ("__future__", "math", "numpy",
                                          "torch"), (path, name)


def test_a_run_without_a_card_fails_and_prints_nothing():
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    proc = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload",
         "perftest_1m.poses", "--seed", "1", "--seconds", "1"],
        cwd=pb_cpu.ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and proc.stdout == ""
