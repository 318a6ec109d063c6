"""Reductions that more than one per-layer metric reads."""
from __future__ import annotations


def idle_share(rec: dict, kind: str) -> float | None:
    """100 x (1 - busy / window) over the traced window of a ``kind``
    run; None where the trace holds no device work."""
    tr = rec.get("trace")
    if rec.get("kind") != kind or tr is None:
        return None
    window = tr.window()
    if window is None:
        return None
    t0, t1 = window
    busy = tr.busy(t0, t1)
    if busy <= 0.0:
        return None
    return 100.0 * (1.0 - busy / (t1 - t0))


def span_ms(rec: dict, kind: str, count, names, stop=()) -> float | None:
    """Device ms, over ``count`` (the traced steps or batches), of the
    events launched inside the program's spans ``names`` less the nested
    ``stop`` spans (``Trace.launched_in``); None outside a traced run of
    ``kind`` or where the trace holds no such span or launch."""
    tr = rec.get("trace")
    if rec.get("kind") != kind or tr is None or not count:
        return None
    s = tr.launched_in(names, stop)
    return None if s is None else 1e3 * s / count


def counters(rec: dict, *names) -> list[float] | None:
    """The program's counters ``names`` of a traced run, each above 0,
    or None."""
    got = rec.get("counters") or {}
    vals = [got.get(n) for n in names]
    if any(v is None or v <= 0 for v in vals):
        return None
    return vals
