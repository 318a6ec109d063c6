"""``repro_torch.obs`` — wave-level observability for the task runtime.

The same ``repro-obs/1`` event schema as the JAX package: wave
open/close with dispatch wall time, per-dispatch timings and modes,
``kernel_dispatch`` decisions of the wave-kernel backend and live
per-channel queue depth.  Sinks are pluggable (in-memory for tests,
JSONL trace files, a console summary); :func:`trace_span` names waves
in ``torch.profiler`` traces.
"""
from .events import EVENT_FIELDS, EVENT_SCHEMA, Event, validate_event
from .profiler import trace_span
from .tracker import (NULL_TRACKER, ConsoleTracker, InMemoryTracker,
                      JsonlTracker, NullTracker, Tracker, TrackerBase,
                      make_tracker, validate_spec)

__all__ = [
    "EVENT_FIELDS", "EVENT_SCHEMA", "Event", "validate_event",
    "Tracker", "TrackerBase", "NullTracker", "NULL_TRACKER",
    "InMemoryTracker", "JsonlTracker", "ConsoleTracker",
    "make_tracker", "validate_spec", "trace_span",
]
