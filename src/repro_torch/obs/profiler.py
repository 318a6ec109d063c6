"""Opt-in ``torch.profiler`` wave annotation.

When ``RuntimeConfig(profile_waves=True)``, the staged executor wraps
every wave dispatch in :func:`trace_span` — a
``torch.profiler.record_function`` range — so a profile captured with
``torch.profiler.profile()`` shows which kernels belong to which wave.
Disabled (the default) the span is a shared no-op context manager and
costs nothing.
"""
from __future__ import annotations

import contextlib

import torch

__all__ = ["trace_span"]

_NULL = contextlib.nullcontext()


def trace_span(label: str, enabled: bool = True):
    """A context manager naming ``label`` in the torch profiler timeline;
    a no-op when ``enabled`` is False."""
    if not enabled:
        return _NULL
    return torch.profiler.record_function(label)
