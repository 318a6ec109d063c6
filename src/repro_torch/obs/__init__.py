"""``repro_torch.obs`` — wave-level observability for the task runtime.

The same ``repro-obs/1`` event schema as the JAX package: wave
open/close with dispatch wall time, per-dispatch timings and modes,
``kernel_dispatch`` decisions of the wave-kernel backend and live
per-channel queue depth, and the DES's predicted-vs-configured cost.
Sinks are pluggable (in-memory for tests, JSONL trace files, a console
summary).  Traces export to Chrome/Perfetto JSON (:mod:`chrome`) and
summarize as markdown (:mod:`summary`; ``python -m repro_torch.obs
summary|chrome TRACE.jsonl``); :func:`trace_span` names waves in
``torch.profiler`` traces and :func:`profile_session` records one.

The LLM path's spans and counters (:mod:`spans`): :func:`span` at the
trainer's, the model step's and the server's layer boundaries, recorded
only inside ``with recording():`` (a no-op otherwise), mapped onto a
profiler trace's clock by :func:`span_events`.
"""
from .chrome import (chrome_trace, export_chrome_trace, load_jsonl,
                     merge_spans, span_events)
from .events import EVENT_FIELDS, EVENT_SCHEMA, Event, validate_event
from .profiler import profile_session, profiler_available, trace_span
from .spans import NULL_SPAN, Recording, current, recording, span
from .summary import mode_latency, slowest_waves, summary_table
from .tracker import (NULL_TRACKER, ConsoleTracker, InMemoryTracker,
                      JsonlTracker, NullTracker, Tracker, TrackerBase,
                      make_tracker, validate_spec)

__all__ = [
    "EVENT_FIELDS", "EVENT_SCHEMA", "Event", "validate_event",
    "Tracker", "TrackerBase", "NullTracker", "NULL_TRACKER",
    "InMemoryTracker", "JsonlTracker", "ConsoleTracker",
    "make_tracker", "validate_spec",
    "chrome_trace", "export_chrome_trace", "load_jsonl",
    "slowest_waves", "mode_latency", "summary_table",
    "trace_span", "profile_session", "profiler_available",
    "span", "recording", "current", "Recording", "NULL_SPAN",
    "span_events", "merge_spans",
]
