"""Human summaries of a trace: totals and the slowest waves (the JAX
package's ``obs/summary.py``, unchanged).

Feeds the CLI (``python -m repro_torch.obs summary TRACE.jsonl --top 5``);
the markdown output renders directly in a GitHub job summary.
"""
from __future__ import annotations

from .events import Event

__all__ = ["slowest_waves", "mode_latency", "summary_table"]


def slowest_waves(events: list[Event], top: int = 5) -> list[Event]:
    """The ``top`` slowest ``wave_close`` events, slowest first (ties
    break on wave order so the result is deterministic)."""
    waves = [e for e in events if e.kind == "wave_close"]
    waves.sort(key=lambda e: (-e.data["wall_s"], e.data["wave"]))
    return waves[:top]


def _percentile(sorted_vals: list[float], q: float) -> float:
    """Nearest-rank percentile over pre-sorted values (pure python — the
    trace CLI must not pull numpy in for a table)."""
    rank = max(int(-(-q * len(sorted_vals) // 100)), 1)   # ceil, >= 1
    return sorted_vals[rank - 1]


def mode_latency(events: list[Event]) -> dict[str, dict]:
    """Per-dispatch-mode latency histogram from ``dispatch`` events:
    ``mode -> {count, total_s, p50_s, p99_s}``, modes sorted by name.

    This is the before/after axis for dispatch-path work (e.g. the vmap
    path vs the wave kernels, mode ``pallas``): the same trace answers
    "where did the wall time go" per mode, with tail latency (p99) next
    to the median."""
    by_mode: dict[str, list[float]] = {}
    for e in events:
        if e.kind == "dispatch":
            by_mode.setdefault(e.data["mode"], []).append(e.data["wall_s"])
    out: dict[str, dict] = {}
    for mode in sorted(by_mode):
        walls = sorted(by_mode[mode])
        out[mode] = {
            "count": len(walls),
            "total_s": sum(walls),
            "p50_s": _percentile(walls, 50),
            "p99_s": _percentile(walls, 99),
        }
    return out


def summary_table(events: list[Event], top: int = 5) -> str:
    """A markdown summary: one totals line plus a top-``top`` slowest
    waves table."""
    kinds: dict[str, int] = {}
    for e in events:
        kinds[e.kind] = kinds.get(e.kind, 0) + 1
    waves = [e for e in events if e.kind == "wave_close"]
    wall = sum(e.data["wall_s"] for e in waves)
    moved = sum(e.data["bytes_moved"] for e in waves)
    staged = sum(e.data["bytes_staged"] for e in waves)
    lines = [f"**trace**: {len(events)} events · {len(waves)} waves · "
             f"{kinds.get('dispatch', 0)} dispatches · "
             f"{wall:.4f} s dispatch wall · {moved} B moved · "
             f"{staged} B staged", ""]
    if waves:
        lines.append(f"| wave | executor | tasks | dispatches | wall s | "
                     f"moved B | staged B |")
        lines.append("|---|---|---|---|---|---|---|")
        for e in slowest_waves(events, top):
            d = e.data
            lines.append(
                f"| {d['wave']} | {d['executor']} | {d['tasks']} | "
                f"{d['dispatches']} | {d['wall_s']:.4f} | "
                f"{d['bytes_moved']} | {d['bytes_staged']} |")
    modes = mode_latency(events)
    if modes:
        lines.append("")
        lines.append("| mode | dispatches | total s | p50 s | p99 s |")
        lines.append("|---|---|---|---|---|")
        for mode, h in modes.items():
            lines.append(
                f"| {mode} | {h['count']} | {h['total_s']:.4f} | "
                f"{h['p50_s']:.4f} | {h['p99_s']:.4f} |")
    return "\n".join(lines)
