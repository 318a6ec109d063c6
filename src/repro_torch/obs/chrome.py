"""Chrome-trace (Perfetto JSON) export of an event stream (the JAX
package's ``obs/chrome.py``, unchanged: the same ``repro-obs/1`` events
give the same document).

Turns a list of :class:`~repro_torch.obs.events.Event` (or a JSONL trace file)
into the ``chrome://tracing`` / https://ui.perfetto.dev JSON array
format: waves and dispatches become complete ("X") duration events,
queue depths become counter ("C") tracks, and everything else becomes
instant ("i") markers — so the per-wave timeline the runtime measured
can be *looked at*, which is how the paper's §6 idle/app/flush
breakdowns were found in the first place.

Timestamps: events carry end-of-span ``ts`` (seconds since tracker
start) and a ``wall_s`` duration; Chrome wants start timestamps in
microseconds, so spans are emitted at ``(ts - wall_s) * 1e6`` clamped at
zero.  The output list is sorted by timestamp (tested monotonic).

The port's spans (:mod:`~repro_torch.obs.spans`) export as complete
events of category ``program_span`` on the epoch clock
(:func:`span_events`), and :func:`merge_spans` adds them to a profiler's
Chrome trace on its host threads' tracks, beside the kernels.
"""
from __future__ import annotations

import json

from .events import Event

__all__ = ["load_jsonl", "chrome_trace", "export_chrome_trace",
           "span_events", "merge_spans"]

_PID = 0
_TID_WAVES = 0
_TID_DISPATCH = 1
_TID_MARKS = 2


def load_jsonl(path) -> list[Event]:
    """Parse a :class:`~repro_torch.obs.tracker.JsonlTracker` trace file."""
    events = []
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if line:
                events.append(Event.from_record(json.loads(line)))
    return events


def _span(name: str, tid: int, end_ts: float, wall_s: float,
          args: dict) -> dict:
    start_us = max(0.0, (end_ts - wall_s)) * 1e6
    return {"name": name, "ph": "X", "pid": _PID, "tid": tid,
            "ts": start_us, "dur": max(0.0, wall_s) * 1e6, "args": args}


def chrome_trace(events: list[Event]) -> dict:
    """The Chrome trace document for ``events`` (a dict with a
    ``traceEvents`` list, ready for ``json.dump``)."""
    out: list[dict] = []
    for tid, name in ((_TID_WAVES, "waves"), (_TID_DISPATCH, "dispatches"),
                      (_TID_MARKS, "markers")):
        out.append({"name": "thread_name", "ph": "M", "pid": _PID,
                    "tid": tid, "ts": 0.0,
                    "args": {"name": name}})
    for ev in events:
        if ev.kind == "trace_header":
            continue
        if ev.kind == "wave_close":
            d = ev.data
            out.append(_span(f"wave {d['wave']} [{d['executor']}]",
                             _TID_WAVES, ev.ts, d["wall_s"], dict(d)))
        elif ev.kind == "dispatch":
            d = ev.data
            out.append(_span(f"{d['fn']} x{d['tasks']} [{d['mode']}]",
                             _TID_DISPATCH, ev.ts, d["wall_s"], dict(d)))
        elif ev.kind == "queue_depth":
            d = ev.data
            out.append({"name": f"queue[{d['channel']}]", "ph": "C",
                        "pid": _PID, "tid": _TID_MARKS, "ts": ev.ts * 1e6,
                        "args": {"depth": d["depth"]}})
        else:
            out.append({"name": ev.kind, "ph": "i", "pid": _PID,
                        "tid": _TID_MARKS, "ts": ev.ts * 1e6, "s": "t",
                        "args": dict(ev.data)})
    out.sort(key=lambda e: e["ts"])
    return {"traceEvents": out, "displayTimeUnit": "ms"}


def export_chrome_trace(events_or_path, out_path) -> dict:
    """Write the Chrome trace JSON for ``events_or_path`` (an event list
    or a JSONL trace file path) to ``out_path``; returns the document."""
    events = (load_jsonl(events_or_path)
              if isinstance(events_or_path, (str, bytes)) or
              hasattr(events_or_path, "__fspath__") else events_or_path)
    doc = chrome_trace(events)
    with open(out_path, "w", encoding="utf-8") as f:
        json.dump(doc, f)
        f.write("\n")
    return doc


def span_events(rec, base_ns: int = 0, pid: int = 0) -> list[dict]:
    """The closed spans of ``rec`` (an ``obs.spans.Recording``) as
    complete (``X``) events of category ``program_span``, in µs after
    ``base_ns`` on the epoch clock, each on its thread's track (``tid``
    the native thread id, as Kineto's host events have it); ``args``
    hold the attributes, the span's index and its parent's."""
    index = {id(s): i for i, s in enumerate(rec.spans)}
    out = []
    for i, s in enumerate(rec.spans):
        if s.end is None:
            continue
        args = dict(s.attrs, span=i)
        if s.parent is not None:
            args["parent"] = index.get(id(s.parent))
        out.append({"name": s.name, "cat": "program_span", "ph": "X",
                    "pid": pid, "tid": s.tid,
                    "ts": (rec.epoch_ns(s.start) - base_ns) / 1e3,
                    "dur": (s.end - s.start) / 1e3, "args": args})
    return out


def merge_spans(path, rec, pid: int = 0) -> int:
    """Add the spans of ``rec`` to the profiler's Chrome trace at
    ``path``, mapped onto its clock (``baseTimeNanoseconds``); returns
    how many were added."""
    with open(path, encoding="utf-8") as f:
        doc = json.load(f)
    events = span_events(rec, int(doc.get("baseTimeNanoseconds", 0)), pid)
    doc.setdefault("traceEvents", []).extend(events)
    with open(path, "w", encoding="utf-8") as f:
        json.dump(doc, f)
    return len(events)
