"""``roofline.py``'s counts of work at the cells' shapes, worked out by
hand."""

import pytest

import pb_cpu  # noqa: F401
from perfbench import roofline


def test_traversal_work_of_the_2m_queue():
    # 2,097,152 extend rays (28 B in, 8 B out), 550,000 valid shadow rays
    # (28 B in, 1 B out), 1,048,496 triangles of 36 B read by both queues
    b, ops = roofline.traversal_work(2_097_152, 550_000, 1_048_496)
    assert b == 2_097_152 * 36 + 550_000 * 29 + 2 * 1_048_496 * 36
    assert b == 166_939_184
    assert ops == (2_097_152 + 550_000) * 45
    least = roofline.least_seconds(b, ops)
    assert least == pytest.approx(b / 3.35e12)  # bytes bound it
    assert least == pytest.approx(49.83e-6, rel=1e-3)


def test_traversal_work_of_the_preset_queue():
    b, ops = roofline.traversal_work(131_072, 40_000.5, 1_048_496)
    assert b == pytest.approx(131_072 * 36 + 40_000.5 * 29
                              + 2 * 1_048_496 * 36)
    assert roofline.least_seconds(b, ops) == pytest.approx(b / 3.35e12)


def test_the_peaks_are_the_data_sheets():
    assert roofline.HBM_BYTES_PER_S == 3.35e12
    assert roofline.FP32_OPS_PER_S == 67e12
