"""Plant each fault of ``perfbench/tests/test_pb_fog_lights.py`` (the
fogged many-light shade's: transmittance dropped, a uniform pick weighted
as a power pick, HG g ignored, the spot cone ignored, the fog stream
re-keyed) under the ``fog_lights_1m.poses`` cell at its own size, on the
card, and print the compared numbers of ``correct``: one JSON line a
fault and seed.

    python3 scripts/fog_lights_faults.py --seeds 31,32 --seconds 3 \\
        --out build/fog_lights_faults.jsonl
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
TESTS = ROOT / "perfbench" / "tests"
for p in (ROOT, TESTS):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

CELL = "fog_lights_1m.poses"


def faults():
    """The test file's faults, by name."""
    spec = importlib.util.spec_from_file_location(
        "test_pb_fog_lights", TESTS / "test_pb_fog_lights.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return {f.__name__: f for f in mod.FAULTS}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seeds", required=True, help="comma-separated seeds")
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--faults", default="",
                   help="comma-separated names (default: all)")
    p.add_argument("--out", default=None, help="a JSON-lines file to append")
    args = p.parse_args(argv)
    import torch

    from perfbench import run
    from perfbench.faults import Patch
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    table = faults()
    names = args.faults.split(",") if args.faults else list(table)
    for name in names:
        for seed in (int(s) for s in args.seeds.split(",")):
            mp = Patch()
            table[name](mp)
            try:
                out = run.run(CELL, seed, args.seconds, False)
            finally:
                mp.undo()
            line = json.dumps({"fault": name, "seed": seed,
                               "frames": out["attempted"],
                               "correct": out["correct"],
                               "checks": out["checks"]})
            print(line, flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
