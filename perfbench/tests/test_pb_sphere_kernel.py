"""The reader of the sphere kernel's share of the ray-sphere tests on a
synthetic snapshot of the program's tracer (``test_pb_tracer``'s): the
window's steps alone, and None where the program has no ``sphere_kernel``
counter or the run no snapshot."""

import copy

import pytest

from perfbench.run import reader
from test_pb_tracer import _ctx, snapshot

NAME = "sphere_kernel_pct.poses"


def _with_tested(tested) -> dict:
    """The snapshot with ``sphere_kernel`` counted: ``tested(step)`` slots
    of each step's 2 x 1000 (extend's queue and connect's)."""
    snap = copy.deepcopy(snapshot())
    for s in snap["steps"]:
        s["counts"]["sphere_kernel"] = tested(s["step"])
    return snap


def test_every_slot_tested_reads_100():
    got = reader("layer_metrics", NAME)(_ctx(_with_tested(lambda k: 2000)))
    assert got == pytest.approx(100.0)


def test_the_window_alone():
    # steps 0-3 in the window: two by the kernel, two plain; steps -1 and 4
    # outside
    snap = _with_tested(lambda k: 2000 if k in (0, 2, 4) else 0)
    assert reader("layer_metrics", NAME)(_ctx(snap)) == pytest.approx(50.0)


def test_a_program_without_the_counter_reads_none():
    for snap in (snapshot(), None):
        assert reader("layer_metrics", NAME)(_ctx(snap)) is None
