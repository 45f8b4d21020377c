"""A short run of each cell on the card, as the command line gives it
(marked ``gpu``: it skips without one)."""

import json
import subprocess
import sys

import pytest

import pb_cpu


@pytest.mark.gpu
@pytest.mark.parametrize("cell", pb_cpu.CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_a_short_run_on_the_card(cell, trace):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    proc = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", cell, "--seed",
         "2147483901", "--seconds", "2", "--trace", str(trace)],
        cwd=pb_cpu.ROOT, capture_output=True, text=True, timeout=360)
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["correct"] and out["device"]["platform"] == "gpu"
    assert list(out)[-1] == "checks"
    if trace:
        assert 0 < out["device"]["busy_s"] <= out["device"]["window_s"]
