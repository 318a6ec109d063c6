"""The Tracker protocol and its sinks.

A tracker is where the runtime's structured events go.  The protocol is
four methods (:meth:`emit`, :meth:`queue`, :meth:`queue_depths`,
:meth:`close`) plus an ``enabled`` flag the hot path guards on — with
the :class:`NullTracker` (the default) no event object is ever even
constructed, so observability off means observability free.

Sinks:

* :class:`InMemoryTracker` — events in a list; what tests assert on.
* :class:`JsonlTracker`    — one JSON record per line in a trace file
  (first line is the ``trace_header``).
* :class:`ConsoleTracker`  — aggregates while running, prints a compact
  summary (totals + slowest waves) at :meth:`close`.

``TaskRuntime`` owns the tracker: ``RuntimeConfig(tracker=...)`` accepts
a spec string (``"memory"``, ``"console"``, ``"jsonl"``,
``"jsonl:PATH"``, ``"none"``) or a ready :class:`TrackerBase` instance —
instances are caller-owned (several runtimes may share one trace file)
and are *not* closed at runtime shutdown; spec-built trackers are.

Beyond recording, the tracker closes a control loop: it maintains the
live per-channel queue depth (workers for the host executor, owner homes
for the sharded one), and ``ShardedExecutor`` feeds that map into
``placement.rebalance_owners`` as the background load the contention
threshold is measured against.
"""
from __future__ import annotations

import threading
import time
from typing import Protocol, runtime_checkable

from .events import EVENT_SCHEMA, Event

__all__ = ["Tracker", "TrackerBase", "NullTracker", "NULL_TRACKER",
           "InMemoryTracker", "JsonlTracker", "ConsoleTracker",
           "make_tracker", "validate_spec", "TRACKER_SPECS"]

TRACKER_SPECS = ("none", "off", "memory", "console", "jsonl")


@runtime_checkable
class Tracker(Protocol):
    """What the runtime requires of an event sink."""

    enabled: bool

    def emit(self, kind: str, **data) -> None:
        """Record one structured event."""
        ...

    def queue(self, channel: int, delta: int) -> None:
        """Adjust a channel's live queue depth and record the new value."""
        ...

    def queue_depths(self) -> dict[int, int]:
        """The live depth per channel (empty when nothing is queued)."""
        ...

    def close(self) -> None:
        ...


class NullTracker:
    """The disabled tracker: ``enabled`` is False and every method is a
    no-op.  Hot paths guard event *construction* on ``enabled``, so with
    this sink no event dict is ever built — zero overhead, guarded by a
    test rather than a wall-clock gate."""

    enabled = False

    def emit(self, kind: str, **data) -> None:
        pass

    def queue(self, channel: int, delta: int) -> None:
        pass

    def queue_depths(self) -> dict[int, int]:
        return {}

    def close(self) -> None:
        pass


NULL_TRACKER = NullTracker()


class TrackerBase:
    """Shared machinery: monotonic timestamps relative to construction,
    the live queue-depth map, and a lock around :meth:`_record` (host
    worker shutdown and the master thread may interleave emits)."""

    enabled = True

    def __init__(self):
        self._t0 = time.perf_counter()
        self._depths: dict[int, int] = {}
        self._lock = threading.Lock()
        self._closed = False

    def emit(self, kind: str, **data) -> None:
        ev = Event(kind=kind, ts=time.perf_counter() - self._t0, data=data)
        with self._lock:
            if not self._closed:
                self._record(ev)

    def queue(self, channel: int, delta: int) -> None:
        ch = int(channel)
        with self._lock:
            # depth read-modify-write under the same lock _record uses:
            # emits arrive from the master, host workers, and dependence
            # pump threads concurrently
            depth = self._depths.get(ch, 0) + int(delta)
            self._depths[ch] = depth
        self.emit("queue_depth", channel=ch, depth=depth)

    def queue_depths(self) -> dict[int, int]:
        with self._lock:
            return dict(self._depths)

    def _record(self, ev: Event) -> None:
        raise NotImplementedError

    def close(self) -> None:
        with self._lock:
            if not self._closed:
                self._closed = True
                self._on_close()

    def _on_close(self) -> None:
        pass


class InMemoryTracker(TrackerBase):
    """Events in a list — the sink tests assert against."""

    def __init__(self):
        super().__init__()
        self.events: list[Event] = []

    def _record(self, ev: Event) -> None:
        self.events.append(ev)

    def events_of(self, kind: str) -> list[Event]:
        return [e for e in self.events if e.kind == kind]


class JsonlTracker(TrackerBase):
    """One JSON record per line in ``path``; the first line is the
    ``trace_header`` carrying the schema version.  The file truncates on
    construction (one tracker = one trace)."""

    def __init__(self, path):
        super().__init__()
        self.path = path
        self.records_written = 0
        self._fh = open(path, "w", encoding="utf-8")
        self.emit("trace_header", schema=EVENT_SCHEMA)

    def _record(self, ev: Event) -> None:
        self._fh.write(ev.to_json() + "\n")
        self.records_written += 1

    def _on_close(self) -> None:
        self._fh.close()


class ConsoleTracker(TrackerBase):
    """The summary sink: aggregates while running, prints at close.

    Wave lines and the final counters come from the same records every
    other sink sees; the ``stats`` event payload is the schema-tagged
    ``RuntimeStats.to_dict()`` — one serialization schema shared between
    the tracker summary and ``RuntimeStats.to_json``."""

    def __init__(self, top: int = 5, out=None):
        super().__init__()
        self.top = top
        self._out = out
        self.kind_counts: dict[str, int] = {}
        self._waves: list[Event] = []
        self._stats: dict | None = None

    def _record(self, ev: Event) -> None:
        self.kind_counts[ev.kind] = self.kind_counts.get(ev.kind, 0) + 1
        if ev.kind == "wave_close":
            self._waves.append(ev)
        elif ev.kind == "stats":
            self._stats = ev.data["stats"]

    def _on_close(self) -> None:
        n = sum(self.kind_counts.values())
        wall = sum(e.data["wall_s"] for e in self._waves)
        moved = sum(e.data["bytes_moved"] for e in self._waves)
        staged = sum(e.data["bytes_staged"] for e in self._waves)
        lines = [f"[obs] {n} events across "
                 f"{self.kind_counts.get('wave_close', 0)} waves / "
                 f"{self.kind_counts.get('dispatch', 0)} dispatches: "
                 f"{wall:.4f} s dispatch wall, "
                 f"{moved} B moved, {staged} B staged"]
        slowest = sorted(self._waves, key=lambda e: -e.data["wall_s"])
        if slowest:
            lines.append("[obs] slowest waves: " + ", ".join(
                f"#{e.data['wave']} {e.data['wall_s']:.4f}s "
                f"({e.data['tasks']} tasks, {e.data['executor']})"
                for e in slowest[:self.top]))
        if self._stats is not None:
            s = self._stats
            lines.append(f"[obs] final stats ({s.get('schema')}): "
                         f"{s.get('tasks_spawned')} tasks, "
                         f"{s.get('deps_found')} deps, "
                         f"{s.get('tile_moves')} tile moves")
        print("\n".join(lines), file=self._out)


def validate_spec(spec: str) -> str:
    """Raise ValueError unless ``spec`` names a known tracker sink."""
    if spec in TRACKER_SPECS or spec.startswith("jsonl:"):
        return spec
    raise ValueError(
        f"tracker spec must be one of {TRACKER_SPECS} or 'jsonl:PATH', "
        f"got {spec!r}")


def make_tracker(spec, default_path: str = "trace.jsonl"):
    """Resolve a ``RuntimeConfig.tracker`` value.

    Returns ``(tracker, owned)``: ``owned`` tells the runtime whether it
    should close the tracker at shutdown (spec-built sinks: yes; a
    caller-provided instance: no — the caller may be sharing it across
    runtimes and closes it itself)."""
    if spec is None or spec in ("none", "off"):
        return NULL_TRACKER, False
    if isinstance(spec, str):
        validate_spec(spec)
        if spec == "memory":
            return InMemoryTracker(), True
        if spec == "console":
            return ConsoleTracker(), True
        if spec == "jsonl":
            return JsonlTracker(default_path), True
        return JsonlTracker(spec.split(":", 1)[1]), True
    if isinstance(spec, Tracker):
        return spec, False
    raise TypeError(f"tracker must be a spec string, a Tracker instance "
                    f"or None, got {type(spec).__name__}")
