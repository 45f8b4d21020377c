"""Shared settings of the benchmark's CPU tests: the checkout on the
import path, and the tiny size at which a cell runs on the CPU (the
program's plain kernel versions, a 64x48 frame, a 4,096-ray queue, a
2,192-triangle terrain)."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY = {"terrain": {"n_tris_target": 2048},
        "render": {"width": 64, "height": 48, "num_rays": 4096}}
CELLS = ("perftest_1m.poses", "preset_128k.fly", "perftest_1m.fly")


def pin_threads():
    """One thread a worker: the tests share the machine."""
    import torch
    torch.set_num_threads(2)
