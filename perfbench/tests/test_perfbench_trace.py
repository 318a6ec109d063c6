"""The trace reductions on a synthetic trace with overlapping kernels."""
from __future__ import annotations

import pytest

from perfbench.trace import Trace, union


def ev(cat, name, ts, dur, tid=1):
    return {"cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid}


EVENTS = [
    ev("user_annotation", "perfbench/window", 0, 1000),
    ev("user_annotation", "perfbench/prefill", 0, 400),
    ev("cpu_op", "aten::mm", 10, 50),
    ev("cpu_op", "aten::copy_", 600, 300, tid=2),
    # two streams overlap in 100..200; a copy and a memset inside
    ev("kernel", "flash_attention_bf16_kernel(args)", 100, 200),
    ev("kernel", "gemm", 150, 100),
    ev("gpu_memcpy", "Memcpy HtoD", 500, 50),
    ev("gpu_memset", "Memset", 540, 20),
    ev("kernel", "flash_attention_bf16_kernel(args)", 700, 100),
]


def test_union_merges_overlaps():
    assert union([(0, 2), (1, 3), (5, 6), (6, 7), (9, 9)]) == \
        [(0, 3), (5, 7)]


def test_busy_counts_overlap_once():
    tr = Trace(EVENTS)
    (t0, t1), = tr.ranges("perfbench/window")
    # 100..300, 500..560, 700..800 microseconds
    assert tr.busy(t0, t1) == pytest.approx(360e-6)
    assert 1 - tr.busy(t0, t1) / (t1 - t0) == pytest.approx(0.64)


def test_kernels_in_windows():
    tr = Trace(EVENTS)
    w = tr.ranges("perfbench/prefill")
    assert tr.kernel_seconds(w, ["flash_attention_bf16_kernel"]) == \
        pytest.approx([200e-6])


def test_idle_gaps_by_host_range():
    tr = Trace(EVENTS)
    gaps = dict(tr.idle_gaps(0.0, 1000e-6))
    # gaps 0..100 and 300..500 begin inside the prefill range (aten::mm
    # has not begun at 0); 560..700 inside the window alone; 800..1000
    # inside aten::copy_, on another thread
    assert gaps["perfbench/prefill"] == pytest.approx(300e-6)
    assert gaps["perfbench/window"] == pytest.approx(140e-6)
    assert gaps["aten::copy_"] == pytest.approx(200e-6)
    assert sum(gaps.values()) == pytest.approx(640e-6)


def test_top_device():
    tr = Trace(EVENTS)
    top = tr.top_device(0.0, 1e-3, n=2)
    assert top[0][0].startswith("flash_attention_bf16_kernel")
    assert top[0][1] == pytest.approx(300e-6)


DEVICE_ONLY = [e for e in EVENTS if e["cat"] not in ("user_annotation",
                                                     "cpu_op")]


def test_device_only_window_is_the_device_span():
    tr = Trace(DEVICE_ONLY)
    t0, t1 = tr.window()
    assert (t0, t1) == pytest.approx((100e-6, 800e-6))
    assert tr.busy(t0, t1) == pytest.approx(360e-6)
    assert Trace([]).window() is None


def test_device_only_kernels_anywhere():
    tr = Trace(DEVICE_ONLY)
    assert tr.ranges("perfbench/prefill") == []
    assert tr.kernel_seconds(None, ["flash_attention_bf16_kernel"]) == \
        pytest.approx([200e-6, 100e-6])


def test_idle_gaps_by_the_device_op_before_them():
    tr = Trace(DEVICE_ONLY)
    gaps = dict(tr.idle_gaps(0.0, 1000e-6))
    # 0..100 before any op; 300..500 after the first flash kernel (the
    # last to end, at 300); 560..700 after the memset; 800..1000 after
    # the second flash kernel
    assert gaps["(window start)"] == pytest.approx(100e-6)
    assert gaps["after flash_attention_bf16_kernel(args)"] == \
        pytest.approx(400e-6)
    assert gaps["after Memset"] == pytest.approx(140e-6)
