"""Opt-in ``torch.profiler`` wave annotation and profiler sessions.

When ``RuntimeConfig(profile_waves=True)``, the staged executor wraps
every wave dispatch in :func:`trace_span` — a
``torch.profiler.record_function`` range — so a profile captured with
``torch.profiler.profile()`` shows which kernels belong to which wave.
Disabled (the default) the span is a shared no-op context manager and
costs nothing.

:func:`profile_session` is the session side of the same story (the JAX
package's ``jax.profiler.start_trace``/``stop_trace`` bracket): the
ranges only land in a trace file if someone profiles around the run.  It
brackets a region with ``torch.profiler.profile`` (the CPU, and the card's
kernels where there is one) and writes a Chrome trace under ``logdir``
when the region ends, also when its body raises, so a partial session
still leaves its trace.  It also opens a span recording
(:mod:`~repro_torch.obs.spans`), whose spans it merges into that trace,
and into which :func:`trace_span` records its ranges too.
"""
from __future__ import annotations

import contextlib
import itertools
import os
import pathlib

import torch

from . import chrome, spans

__all__ = ["trace_span", "profile_session", "profiler_available"]

_NULL = contextlib.nullcontext()
_SESSIONS = itertools.count()


def profiler_available() -> bool:
    """True when ``torch.profiler`` can record a session here (its Kineto
    back end is built in)."""
    return bool(torch.profiler.kineto_available())


def trace_span(label: str, enabled: bool = True):
    """A context manager naming ``label`` in the torch profiler timeline,
    and in the open span recording if there is one; a no-op when
    ``enabled`` is False."""
    if not enabled:
        return _NULL
    if spans.current() is None:
        return torch.profiler.record_function(label)
    return _recorded(label)


@contextlib.contextmanager
def _recorded(label: str):
    with torch.profiler.record_function(label), spans.span(label):
        yield


@contextlib.contextmanager
def profile_session(logdir: str | os.PathLike | None,
                    cuda: bool | None = None):
    """Profile the region inside the ``with`` and write its Chrome trace
    to ``<logdir>/bddt-<pid>-<n>.pt.trace.json`` at the end.

    Yields the running ``torch.profiler.profile`` (its ``trace_path``
    names the file once the region has ended, its ``recording`` the
    span recording, whose spans the file holds), or False when
    ``logdir`` is falsy: then nothing is recorded, so callers never need
    to guard.  Inside a recording that is already open the session
    records into that one.
    ``cuda`` asks for the card's activity: None records it where CUDA is
    available; True raises ``RuntimeError`` where it is not, rather than
    record the CPU alone; False records the CPU only."""
    if not logdir:
        yield False
        return
    if cuda is None:
        cuda = torch.cuda.is_available()
    elif cuda and not torch.cuda.is_available():
        raise RuntimeError("profile_session(cuda=True) on a machine without "
                           "CUDA: no device activity can be recorded")
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    out = pathlib.Path(logdir)
    out.mkdir(parents=True, exist_ok=True)
    prof = torch.profiler.profile(activities=acts)
    rec = spans.current()
    try:
        with (spans.recording() if rec is None else
              contextlib.nullcontext(rec)) as rec:
            prof.recording = rec
            prof.start()
            try:
                yield prof
            finally:
                if cuda:
                    torch.cuda.synchronize()
                prof.stop()
    finally:
        prof.trace_path = out / \
            f"bddt-{os.getpid()}-{next(_SESSIONS)}.pt.trace.json"
        prof.export_chrome_trace(str(prof.trace_path))
        chrome.merge_spans(prof.trace_path, rec, pid=os.getpid())
