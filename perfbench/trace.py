"""The profiler's trace, read once: device intervals, host ranges, the
launch call behind each device event, and the reductions the per-layer
metrics take from them.

The profiler writes its Chrome trace to a temporary file (under
``TMPDIR``), which is parsed and deleted at once.  Device time is the
union of the kernel, copy and memset intervals, so that work on
overlapping streams counts once: the busy seconds of a window are the
length of that union inside it, and its idle share is the rest.

The program's spans (``obs.span_events``, mapped onto the trace's clock
by its ``baseTimeNanoseconds``) join the host ranges as category
``program_span``.  Each device event carries the ``correlation`` of the
CUDA runtime or driver call that launched it, so its time can be put
down to the spans open when that call began (:meth:`Trace.launched_in`).

On the card a traced run records the device's activity alone, and its
window is the span from the first device event to the end of the last;
on the CPU the window is the harness's range ``perfbench/window``.
"""
from __future__ import annotations

import bisect
import heapq
import json
import os
import tempfile

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "program_span")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def union(intervals) -> list[tuple[float, float]]:
    """Sorted, disjoint intervals covering the same points."""
    out: list[list[float]] = []
    for a, b in sorted(intervals):
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def clip(intervals, t0: float, t1: float) -> list[tuple[float, float]]:
    return [(max(a, t0), min(b, t1)) for a, b in intervals
            if b > t0 and a < t1]


class Trace:
    """Events of one profiled run, times in seconds."""

    def __init__(self, events: list[dict], file_bytes: int = 0):
        self.file_bytes = file_bytes    # the exported file's size
        self.device = []            # (start, end, name)
        self.host = []              # (start, end, name, tid, cat)
        self.launch = {}            # correlation: the launch call's start
        self.correlated = []        # (start, end, correlation) on device
        for e in events:
            cat = e.get("cat")
            if "ts" not in e or "dur" not in e:
                continue
            t0 = float(e["ts"]) / 1e6
            t1 = t0 + float(e["dur"]) / 1e6
            corr = (e.get("args") or {}).get("correlation")
            if cat in DEVICE_CATS:
                self.device.append((t0, t1, e.get("name", "")))
                if corr is not None:
                    self.correlated.append((t0, t1, corr))
            elif cat in LAUNCH_CATS:
                if corr is not None:
                    self.launch[corr] = t0
            elif cat in HOST_CATS:
                self.host.append((t0, t1, e.get("name", ""), e.get("tid"),
                                  cat))
        self.device.sort()
        self.host.sort()
        self.busy_union = union((a, b) for a, b, _ in self.device)
        self._busy_starts = [a for a, _ in self.busy_union]

    @classmethod
    def of(cls, prof, spans=None) -> "Trace":
        """Export ``prof``'s Chrome trace, parse it and delete the file.
        ``spans``, a function of the trace's ``baseTimeNanoseconds``,
        gives events to add: the program's spans on the trace's clock."""
        fd, path = tempfile.mkstemp(prefix="perfbench-", suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            size = os.path.getsize(path)
            with open(path, encoding="utf-8") as f:
                doc = json.load(f)
        finally:
            os.unlink(path)
        events = doc.get("traceEvents", [])
        if spans is not None:
            events = events + spans(int(doc.get("baseTimeNanoseconds", 0)))
        return cls(events, size)

    def ranges(self, name: str) -> list[tuple[float, float]]:
        """The host ranges (``record_function``) called ``name``."""
        return [(a, b) for a, b, n, _, cat in self.host
                if n == name and cat == "user_annotation"]

    def spans(self, name: str) -> list[tuple[float, float]]:
        """The program's spans called ``name``."""
        return [(a, b) for a, b, n, _, cat in self.host
                if n == name and cat == "program_span"]

    def launched_in(self, names, stop=()) -> float | None:
        """Device seconds (the union) of the events whose launch call
        began inside a program span of ``names`` and not inside a span of
        ``stop`` nested in it, unless a span of ``names`` nested in that
        holds it again: the innermost span of either kind open at the
        launch is one of ``names``.  Spans of any thread count, so a
        backward pass that the autograd engine's thread launches belongs
        to ``train/backward``.  None where the trace has no span of
        ``names`` or no launch call."""
        marks = sorted((a, b, n in names) for a, b, n, _, cat in self.host
                       if cat == "program_span" and
                       (n in names or n in stop))
        if not any(counted for _, _, counted in marks) or not self.launch:
            return None
        events = sorted((self.launch[c], a, b) for a, b, c in self.correlated
                        if c in self.launch)
        open_: list = []                 # heap of (-start, end, counted)
        kept, i = [], 0
        for t, a, b in events:
            while i < len(marks) and marks[i][0] <= t:
                heapq.heappush(open_, (-marks[i][0], marks[i][1],
                                       marks[i][2]))
                i += 1
            while open_ and open_[0][1] <= t:
                heapq.heappop(open_)
            if open_ and open_[0][2]:
                kept.append((a, b))
        return sum(b - a for a, b in union(kept))

    def window(self) -> tuple[float, float] | None:
        """The traced window: the range ``perfbench/window``, or the span
        of the device's events; None where there are neither."""
        marked = self.ranges("perfbench/window")
        if len(marked) == 1:
            return marked[0]
        if not self.device:
            return None
        return self.device[0][0], max(b for _, b, _ in self.device)

    def busy(self, t0: float, t1: float) -> float:
        """Device busy seconds inside (t0, t1)."""
        j = max(0, bisect.bisect_right(self._busy_starts, t0) - 1)
        k = bisect.bisect_left(self._busy_starts, t1)
        return sum(min(b, t1) - max(a, t0)
                   for a, b in self.busy_union[j:k] if b > t0)

    def kernel_seconds(self, windows, parts) -> list[float]:
        """Durations of the device events whose name holds one of
        ``parts`` and which start inside one of ``windows`` (anywhere,
        for ``windows`` None)."""
        out = []
        for a, b, name in self.device:
            if any(p in name for p in parts) and (windows is None or any(
                    w0 <= a < w1 for w0, w1 in windows)):
                out.append(b - a)
        return out

    def top_device(self, t0: float, t1: float, n: int = 10) -> list:
        """The ``n`` device operations with the most time in the window,
        by name: ``[[name, seconds], ...]``."""
        by: dict[str, float] = {}
        for a, b, name in self.device:
            if b > t0 and a < t1:
                by[name] = by.get(name, 0.0) + min(b, t1) - max(a, t0)
        return [[k[:120], v] for k, v in
                sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, t0: float, t1: float, n: int = 10,
                  longest: int = 400) -> list:
        """The device's idle time in the window by what the host was doing
        as each gap began (the latest-started host range still open then,
        on any thread), over the ``longest`` gaps: ``[[name, seconds],
        ...]``.  Where the host was not recorded, by the device operation
        that ended as the gap began (``after <name>``)."""
        busy = clip(self.busy_union, t0, t1)
        gaps, at = [], t0
        for a, b in busy:
            if a > at:
                gaps.append((at, a))
            at = max(at, b)
        if at < t1:
            gaps.append((at, t1))
        gaps = sorted(sorted(gaps, key=lambda g: g[0] - g[1])[:longest])
        by: dict[str, float] = {}
        if not self.host:
            ends = sorted((b, name) for _, b, name in self.device)
            j = 0
            for g0, g1 in gaps:
                while j + 1 < len(ends) and ends[j + 1][0] <= g0:
                    j += 1
                name = ("after " + ends[j][1]) if ends and \
                    ends[j][0] <= g0 else "(window start)"
                by[name] = by.get(name, 0.0) + g1 - g0
            return [[k[:120], v] for k, v in
                    sorted(by.items(), key=lambda kv: -kv[1])[:n]]
        open_: list = []                 # heap of (-start, end, name)
        i = 0
        for g0, g1 in gaps:
            while i < len(self.host) and self.host[i][0] <= g0:
                heapq.heappush(open_, (-self.host[i][0], self.host[i][1],
                                       self.host[i][2]))
                i += 1
            while open_ and open_[0][1] <= g0:
                heapq.heappop(open_)
            name = open_[0][2] if open_ else "(no host range)"
            by[name] = by.get(name, 0.0) + g1 - g0
        return [[k[:120], v] for k, v in
                sorted(by.items(), key=lambda kv: -kv[1])[:n]]
