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


def launch(cat, ts, corr, tid=1):
    return {"cat": cat, "name": "cudaLaunchKernel", "ts": ts, "dur": 2,
            "tid": tid, "args": {"correlation": corr}}


def kernel(name, ts, dur, corr):
    return {"cat": "kernel", "name": name, "ts": ts, "dur": dur, "tid": 7,
            "args": {"correlation": corr}}


# a forward on thread 1 (a block with attention in it), then a backward
# on thread 2 whose MoE span holds a recomputed block, which holds the
# block's own attention and MoE again; launches at the times below, each
# kernel 10 us long, launched 5 us before it runs
SPANS = [
    ev("program_span", "train/forward", 0, 100),
    ev("program_span", "model/block", 10, 60),
    ev("program_span", "attn/core", 20, 10),
    ev("program_span", "train/backward", 200, 300),
    ev("program_span", "moe/ffn.bwd", 200, 200, tid=2),
    ev("program_span", "model/block", 210, 90, tid=2),
    ev("program_span", "attn/core", 220, 20, tid=2),
    ev("program_span", "moe/ffn", 250, 30, tid=2),
]
LAUNCHED = {1: 5, 2: 15, 3: 25, 4: 205, 5: 215, 6: 225, 7: 260, 8: 290,
            9: 350, 10: 450}


def launched_trace(extra=()):
    events = list(SPANS) + list(extra)
    for corr, t in LAUNCHED.items():
        cat = "cuda_driver" if corr == 8 else "cuda_runtime"
        events.append(launch(cat, t, corr, tid=1 if t < 200 else 2))
        events.append(kernel(f"k{corr}", t + 5, 10, corr))
    return Trace(events)


def test_launched_in_a_phase():
    tr = launched_trace()
    # kernels 1-3 run at 10..20, 20..30, 30..40
    assert tr.launched_in(["train/forward"]) == pytest.approx(30e-6)
    # a launch on the autograd engine's thread belongs to the backward
    # span of the main thread: kernels 4-10
    assert tr.launched_in(["train/backward"]) == pytest.approx(70e-6)


def test_launched_in_less_a_nested_stop_span():
    tr = launched_trace()
    # attention: kernel 3 (forward) and 6 (recomputed); the block around
    # them stops nothing that attention holds
    assert tr.launched_in(["attn/core"], ["model/block"]) == \
        pytest.approx(20e-6)
    # the MoE FFN: 4 (before the block), 7 (its own recompute, in
    # moe/ffn inside the block), 9 (after the block); not 5, 6 or 8,
    # which the recomputed block launched outside its MoE span
    assert tr.launched_in(["moe/ffn", "moe/ffn.bwd"], ["model/block"]) == \
        pytest.approx(30e-6)
    # without the stop span, the whole recompute counts
    assert tr.launched_in(["moe/ffn", "moe/ffn.bwd"]) == \
        pytest.approx(60e-6)


def test_launched_in_counts_overlap_once_and_unlaunched_not_at_all():
    tr = launched_trace([
        kernel("side", 12, 10, 3),          # overlaps kernels 1 and 2's
        kernel("orphan", 60, 10, 99)])      # no launch call in the trace
    assert tr.launched_in(["train/forward"]) == pytest.approx(30e-6)


def test_launched_in_reads_nothing_without_spans_or_launches():
    tr = launched_trace()
    assert tr.launched_in(["serve/decode"]) is None
    assert Trace(SPANS + [kernel("k", 10, 5, 1)]).launched_in(
        ["train/forward"]) is None
    assert Trace(EVENTS).launched_in(["train/forward"]) is None


def test_spans_and_busy_inside_them():
    tr = launched_trace()
    (a0, b0), (a1, b1) = tr.spans("model/block")
    assert (a0, b0, a1, b1) == pytest.approx((10e-6, 70e-6, 210e-6, 300e-6))
    assert tr.ranges("model/block") == []
    # kernels at 10..40 (1-3), 210..240 (4-6), 265..275 (7), 295..305 (8)
    assert sum(tr.busy(a, b) for a, b in tr.spans("model/block")) == \
        pytest.approx(30e-6 + 30e-6 + 10e-6 + 5e-6)
    assert tr.busy(1.0, 2.0) == 0.0 and tr.busy(0.0, 5e-6) == 0.0


def test_spans_join_on_the_traces_clock(tmp_path, monkeypatch):
    """``Trace.of`` hands the trace's base to the spans' function."""
    import json
    import tempfile
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    bases = []

    class Prof:
        def export_chrome_trace(self, path):
            with open(path, "w", encoding="utf-8") as f:
                json.dump({"baseTimeNanoseconds": 5_000_000,
                           "traceEvents": EVENTS}, f)

    def spans(base_ns):
        bases.append(base_ns)
        return [ev("program_span", "serve/decode", 600, 100)]
    tr = Trace.of(Prof(), spans)
    assert bases == [5_000_000]
    (a, b), = tr.spans("serve/decode")
    assert (a, b) == pytest.approx((600e-6, 700e-6))
    assert tr.busy(a, b) == pytest.approx(0.0)
    assert list(tmp_path.iterdir()) == []
