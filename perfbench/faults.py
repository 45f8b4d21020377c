"""Faults planted under the timed path, each of which ``correct`` has to
catch: the CPU tests plant them at a tiny size, and this script reads the
compared numbers of a cell run with one of them on the card, at the cell's
own size.  The benchmark's runs plant none.

    python3 perfbench/faults.py --workload perftest_1m.poses \\
        --fault shadow_overcount --seeds 21,22,23 --seconds 3

Each seed prints one JSON line: the fault, the seed and the compared
numbers with their limits.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


class Patch:
    """``setattr`` that can be undone (the part of pytest's monkeypatch
    that a fault needs)."""

    def __init__(self):
        self._undo = []

    def setattr(self, obj, name, value):
        self._undo.append((obj, name, getattr(obj, name)))
        setattr(obj, name, value)

    def undo(self):
        for obj, name, value in reversed(self._undo):
            setattr(obj, name, value)
        self._undo.clear()


def unchanged(mp):
    """The step returns its state unchanged."""
    import tyrant_tpu_torch.render as render
    mp.setattr(render, "render_step", lambda state, *a, **k: state)


def half_batch(mp):
    """The extend pass traces half of the queue; the other half reads as
    misses."""
    import torch
    import tyrant_tpu_torch.render as render
    orig = render._intersect_scene

    def half(origin, direction, *a, **k):
        t, ident, is_tri, *rest = orig(origin, direction, *a, **k)
        drop = torch.arange(t.shape[0], device=t.device) >= t.shape[0] // 2
        return (torch.where(drop, torch.full_like(t, 1e20), t),
                torch.where(drop, torch.full_like(ident, -1), ident),
                is_tri & ~drop,
                *(torch.where(drop[:, None], torch.zeros_like(r), r)
                  for r in rest))
    mp.setattr(render, "_intersect_scene", half)


def altered(mp):
    """Every flushed radiance is 1% too bright where it is accumulated."""
    import tyrant_tpu_torch.render as render
    orig = render.accumulate_terminated
    mp.setattr(render, "accumulate_terminated",
               lambda accum, key_s, pend_s, **kw:
               orig(accum, key_s, pend_s * 1.01, **kw))


def shadow_overcount(mp):
    """A step counts a sixth more valid shadow rays than it traced: about
    the over-count that raises ``mrays_per_s`` by its bound (shadow rays
    are a fifth of its count)."""
    import dataclasses

    import tyrant_tpu_torch.render as render
    orig = render.render_step

    def step(state, *a, **k):
        new = orig(state, *a, **k)
        inc = new.shadow_rays - state.shadow_rays
        return dataclasses.replace(
            new, shadow_rays=state.shadow_rays + inc + inc // 6)
    mp.setattr(render, "render_step", step)


def _display(mp, wrong):
    import tyrant_tpu_torch.render as render
    orig = render.tonemap_image
    mp.setattr(render, "tonemap_image",
               lambda cl, operator="reinhard", exposure=1.0:
               wrong(orig, cl, operator, exposure))


def gamma(mp):
    """The display resolve takes gamma 2.0 for 2.2."""
    _display(mp, lambda orig, cl, op, ex: orig(cl, op, ex) ** (2.2 / 2.0))


def no_reinhard(mp):
    """The display resolve leaves out the Reinhard curve."""
    import torch
    _display(mp, lambda orig, cl, op, ex:
             torch.pow(torch.clamp(cl * ex, 0.0, 1.0), 1.0 / 2.2))


def swapped(mp):
    """The display resolve swaps the red and blue channels."""
    _display(mp, lambda orig, cl, op, ex: orig(cl, op, ex).flip(-1))


STEP_FAULTS = (unchanged, half_batch, altered)
DISPLAY_FAULTS = (gamma, no_reinhard, swapped)
FAULTS = {f.__name__: f for f in
          (*STEP_FAULTS, shadow_overcount, *DISPLAY_FAULTS)}


def read(workload: str, fault: str, seeds: list[int], seconds: float,
         device="cuda", tiny: dict | None = None):
    """Yield the compared numbers of a run of the cell a seed, with the
    fault planted."""
    from perfbench import run
    for seed in seeds:
        mp = Patch()
        FAULTS[fault](mp)
        try:
            out = run.run(workload, seed, seconds, False, device=device,
                          tiny=tiny)
        finally:
            mp.undo()
        yield {"workload": workload, "fault": fault, "seed": seed,
               "frames": out["attempted"], "correct": out["correct"],
               "checks": out["checks"]}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--fault", required=True, choices=sorted(FAULTS))
    p.add_argument("--seeds", required=True,
                   help="comma-separated run seeds")
    p.add_argument("--seconds", type=float, default=3.0)
    args = p.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    seeds = [int(s) for s in args.seeds.split(",")]
    for reading in read(args.workload, args.fault, seeds, args.seconds):
        print(json.dumps(reading), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
