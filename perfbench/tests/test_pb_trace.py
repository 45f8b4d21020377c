"""The trace arithmetic on a synthetic trace: the union of busy intervals,
the traced windows as device spans, the idle gaps and their names, the
device time launched inside a named range, and the per-layer readers
that use them."""

import pytest

import pb_cpu  # noqa: F401
from perfbench import trace
from perfbench.run import Context, reader


def _x(cat, name, ts, dur, corr=None, tid=1):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def synthetic():
    return trace.Trace([
        _x("user_annotation", "perfbench.window", 0, 100),
        _x("user_annotation", "perfbench.step", 5, 30),
        _x("user_annotation", "shade", 15, 10),
        _x("cuda_runtime", "cudaGraphLaunch", 10, 2, corr=1),
        _x("cuda_runtime", "cudaLaunchKernel", 20, 2, corr=2),
        _x("cuda_runtime", "cudaMemcpyAsync", 30, 2, corr=3),
        _x("cuda_runtime", "cudaDeviceSynchronize", 85, 14),
        _x("kernel", "traverse_kernel<true, false>", 40, 10, corr=1),
        _x("kernel", "shade_op", 45, 15, corr=2),   # overlaps the first
        _x("gpu_memcpy", "Memcpy DtoH", 70, 10, corr=3),
        _x("kernel", "outside", 200, 10, corr=9),   # launched elsewhere
    ])


def test_union_merges_overlaps():
    assert trace.union([(5, 6), (0, 2), (1, 3), (3, 4)]) == [(0, 4), (5, 6)]
    assert trace.length(trace.union([(0, 10), (2, 3), (9, 12)])) == 12


def test_windows_busy_and_gaps():
    t = synthetic()
    win = t.windows()
    assert win == [(40.0, 80.0)]            # the device span launched inside
    busy = t.busy(win)
    assert busy == [(40.0, 60.0), (70.0, 80.0)]
    assert trace.length(busy) == 30.0
    assert t.gaps(win) == [(60.0, 70.0)]
    assert t.host_at(60.0) == "perfbench.window"
    assert t.device_time(win, ("traverse_kernel",)) == 10.0
    assert t.launched_in("shade") == 15.0   # the op launched at ts 20


def test_breakdown_in_seconds():
    b = trace.breakdown(synthetic(), [(40.0, 80.0)])
    name, seconds = b["device_ops"][0]
    assert name == "shade_op" and seconds == pytest.approx(15e-6)
    ((host, gap),) = b["idle_gaps"]
    assert host == "perfbench.window" and gap == pytest.approx(10e-6)


def test_readers_on_the_synthetic_trace():
    t = synthetic()
    ctx = Context(render={"num_rays": 2_097_152},
                  trace=t, windows=t.windows(), profiled_steps=1,
                  profiled_shadow_rays=550_000, stage_trace=t,
                  stage_steps=1, triangles=1_048_496)
    assert reader("layer_metrics", "step_device_ms.poses")(ctx) == 0.03
    assert reader("layer_metrics", "device_idle_pct.poses")(ctx) == 25.0
    assert reader("layer_metrics", "device_idle_pct.fly")(ctx) == 25.0
    assert reader("layer_metrics", "device_idle_pct.preset")(ctx) == 25.0
    assert reader("layer_metrics", "shade_device_ms.poses")(ctx) == 0.015
    # 166,939,184 B at 3.35 TB/s over 10 us of traversal kernels
    assert reader("layer_metrics", "traverse_roofline")(ctx) == \
        pytest.approx(100 * 166_939_184 / 3.35e12 / 10e-6)


def test_readers_that_find_nothing_return_none():
    ctx = Context(render={"num_rays": 8})
    for name in ("step_device_ms.poses", "device_idle_pct.poses",
                 "shade_device_ms.poses", "traverse_roofline",
                 "device_idle_pct.fly", "device_idle_pct.preset"):
        assert reader("layer_metrics", name)(ctx) is None
