"""The bounds chip_smoke.py holds the accumulation and stream kernels
against, on counts worked out by hand: the accumulation's bytes (the keys
through the first at or above P, a sector a block of the suffix after it,
the values of the entries below P, each touched pixel's row read and
written) and the stream traversal's frontier floor (each pair written and
read back once).  chip_smoke imports no JAX, and these helpers need no
card."""

import pytest
import torch

import chip_smoke

HBM = 3.35e12  # bytes/s, the H100 SXM's HBM3


def test_accum_bound_counts_keys_values_and_rows():
    # 1,000 keys, 100 below P on 50 pixels, 12-byte values (count implied):
    # 101 keys through the first at or above P (404 bytes), 4 sectors for
    # the 899-entry suffix (128), 1,200 value bytes and 50 x 32 row bytes:
    # 3,332 bytes against 400 adds
    ms, by = chip_smoke.accum_bound(1000, 100, 50, 12)
    assert by == "bytes"
    assert ms == pytest.approx(3332 / HBM * 1e3, rel=1e-12)
    # phase 2's column, 16-byte values: 1,886,891 keys (7,547,564 bytes) +
    # 822 sectors for the 210,261-entry suffix (26,304) + 30,190,240
    # value bytes + 39,636,992 row bytes = 77,401,100 bytes
    ms, by = chip_smoke.accum_bound(2_097_152, 1_886_890, 1_238_656, 16)
    assert by == "bytes"
    assert ms == pytest.approx(77_401_100 / HBM * 1e3, rel=1e-12)
    assert 0.02310 < ms < 0.02311
    # a step's queue, 12-byte values: 442,332 keys (1,769,328 bytes) +
    # 6,465 sectors for the 1,654,820-entry suffix (206,880) + 5,307,972
    # value bytes + 13,400,928 row bytes = 20,685,108 bytes
    ms, _ = chip_smoke.accum_bound(2_097_152, 442_331, 418_779, 12)
    assert ms == pytest.approx(20_685_108 / HBM * 1e3, rel=1e-12)
    # nothing below P: the first key and one sector for the other 255
    ms, _ = chip_smoke.accum_bound(256, 0, 0, 12)
    assert ms == pytest.approx(36 / HBM * 1e3, rel=1e-12)
    # every entry below P: every key, no suffix
    ms, _ = chip_smoke.accum_bound(512, 512, 3, 16)
    assert ms == pytest.approx((2048 + 8192 + 96) / HBM * 1e3, rel=1e-12)


def test_accum_bound_moment2_buffer():
    # the moment2 mode: the same keys and 12-byte values, the 32 row bytes
    # of each of the 50 pixels in both buffers (3,200), 11 operations a
    # live entry: 404 + 128 + 1,200 + 3,200 = 4,932 bytes against 1,100
    ms, by = chip_smoke.accum_bound(1000, 100, 50, 12, buffers=2)
    assert by == "bytes"
    assert ms == pytest.approx(4932 / HBM * 1e3, rel=1e-12)
    # an adaptive step's queue at 1080p: 807,270 keys (3,229,080
    # bytes) + 5,039 sectors for the 1,289,882-entry suffix (161,248) +
    # 9,687,228 value bytes + 41,118,720 row bytes = 54,196,276 bytes
    ms, by = chip_smoke.accum_bound(2_097_152, 807_269, 642_480, 12,
                                    buffers=2)
    assert by == "bytes"
    assert ms == pytest.approx(54_196_276 / HBM * 1e3, rel=1e-12)


def test_frontier_floor_writes_and_reads_each_pair_once():
    # 4 + 6 + 2 = 12 pairs of 12 bytes, each written and read: 288 bytes
    assert chip_smoke.frontier_floor_ms([4, 6, 2]) == pytest.approx(
        288 / HBM * 1e3, rel=1e-12)
    # the extend queue's 10,444,816 pairs: 250,675,584 bytes
    floor = chip_smoke.frontier_floor_ms([10_444_816])
    assert floor == pytest.approx(250_675_584 / HBM * 1e3, rel=1e-12)
    assert 0.0748 < floor < 0.0749
    assert chip_smoke.frontier_floor_ms([]) == 0.0


def test_kernel_ms_reads_a_trace_it_cannot_match_as_not_measured(
        monkeypatch):
    def traced(records):
        monkeypatch.setattr(chip_smoke, "kernel_times",
                            lambda fn, names, reps: records)

    # one record lost of four: the mean of the other three, in ms
    traced([("accum_kernel", 0.0, 4.0)] * 2 + [None, ("accum_kernel", 9.0,
                                                      7.0)])
    assert chip_smoke.kernel_ms(None, ("accum_kernel",), 4) == \
        pytest.approx(0.005)
    # a launch too many, or every record lost: not measured, no error
    traced([("accum_kernel", 0.0, 4.0)] * 5)
    assert chip_smoke.kernel_ms(None, ("accum_kernel",), 4) is None
    traced([None] * 4)
    assert chip_smoke.kernel_ms(None, ("accum_kernel",), 4) is None
    assert chip_smoke.fmt_ms(None) == "not measured"
    assert chip_smoke.fmt_ms(0.00745) == "0.0075 ms"


def test_live_entries_counts_entries_and_pixels_below_p():
    key = torch.tensor([0, 0, 3, 5, 5, 5, 8, 9, 10, 4096], dtype=torch.int32)
    assert chip_smoke.live_entries(key, 9) == (7, 4)
    assert chip_smoke.live_entries(key, 0) == (0, 0)
