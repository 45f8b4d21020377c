"""The control of ``correct``: the plain reference computed in bfloat16,
the nearest precision below the configuration's float32, put in the
program's place.  For each seed it drives the cell's own mix at the
cell's own size for a short window, collects the sampled pixels as a run
does, and gives two readings of the compared numbers: the program's
against the float32 reference (the lower reading) and the bfloat16
reference's against the float32 one (the control, which has to come out
over the limit of one of them; it shows no frame, so it has no
``display_off_pct``).  The benchmark's runs do not run it.

    python3 perfbench/control.py --workload perftest_1m.poses \\
        --seeds 11,12,13 --seconds 3 --out chiprun_out/control.jsonl

Each seed prints one JSON line (and appends it to ``--out``).
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench import run as bench  # noqa: E402


def control(workload: str, seeds: list[int], seconds: float,
            device="cuda", tiny: dict | None = None, root: Path = ROOT):
    """Yield one reading a seed: {"seed", "program", "control"}, each a
    dict of the compared numbers.  The scene is built once; each seed gets
    its own Renderer on the scene's device tables."""
    import numpy as np
    import torch
    from tyrant_tpu_torch.render import Renderer

    from perfbench import check
    from perfbench.drive import Driver, Mix

    manifest = bench.load_manifest(root)
    cell, conf = bench.find(manifest, workload)
    config = json.loads((root / conf["file"]).read_text())
    mix = Mix.load(cell["traffic"], root / "perfbench" / "traffic")
    base, scene_kw, render, _ = bench.build(config, seeds[0], device, tiny,
                                            root)
    dev = base.device
    ref32 = bench.reference_step(scene_kw, config, render, dev, root=root)
    ref16 = bench.reference_step(scene_kw, config, render, dev,
                                 torch.bfloat16, root)
    for seed in seeds:
        t = time.perf_counter()
        rng = np.random.default_rng(seed % (1 << 64))
        ren = Renderer(base.scene, dataclasses.replace(
            base.cfg, seed=bench.run_seed(seed)), device=dev,
            tables=base.tables, sun_position=base.sun_position)
        driver = Driver(ren, mix, bench.camera_factory())
        driver.warm_up()
        w = driver.window(seconds, keep=bench.keep_frames(rng, mix))
        steps, frames, shown = bench.collect(driver, w, render, rng)
        del driver, ren
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        checked = steps + frames
        rseed = bench.run_seed(seed)
        r32 = check.follow_all(ref32, checked, rseed)
        r16 = check.follow_all(ref16, checked, rseed)
        program = check.judge(steps, frames,
                              check.program_outcomes(checked), r32)
        if shown is not None:
            program["display_off_pct"] = check.display_off(shown, dev)
        yield {"seed": seed, "workload": workload, "frames": w.frames,
               "program": program,
               "control": check.judge(steps, frames, r16, r32),
               "seconds": time.perf_counter() - t}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True,
                   help="comma-separated run seeds")
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--out", type=Path)
    args = p.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    seeds = [int(s) for s in args.seeds.split(",")]
    for reading in control(args.workload, seeds, args.seconds):
        line = json.dumps(reading)
        print(line, flush=True)
        if args.out:
            args.out.parent.mkdir(parents=True, exist_ok=True)
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
