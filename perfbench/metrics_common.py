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
