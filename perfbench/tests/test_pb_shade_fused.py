"""The reader of the shade kernel's share of the queue slots on a
synthetic snapshot of the program's tracer (``test_pb_tracer``'s): the
window's steps alone, and None where the program has no ``shade_fused``
counter or the run no snapshot."""

import copy

import pytest

from perfbench.run import reader
from test_pb_tracer import _ctx, snapshot

NAME = "shade_fused_pct.poses"


def _with_fused(fused) -> dict:
    """The snapshot with ``shade_fused`` counted: ``fused(step)`` slots of
    each step's 1000."""
    snap = copy.deepcopy(snapshot())
    for s in snap["steps"]:
        s["counts"]["shade_fused"] = fused(s["step"])
    return snap


def test_every_slot_fused_reads_100():
    got = reader("layer_metrics", NAME)(_ctx(_with_fused(lambda k: 1000)))
    assert got == pytest.approx(100.0)


def test_the_window_alone():
    # steps 0-3 in the window: two fused, two plain; steps -1 and 4 outside
    snap = _with_fused(lambda k: 1000 if k in (0, 2, 4) else 0)
    assert reader("layer_metrics", NAME)(_ctx(snap)) == pytest.approx(50.0)


def test_a_program_without_the_counter_reads_none():
    for snap in (snapshot(), None):
        assert reader("layer_metrics", NAME)(_ctx(snap)) is None
