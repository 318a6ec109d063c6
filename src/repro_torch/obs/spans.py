"""Spans and counters of the port's LLM path: one recorder, off by
default.

:func:`span` names a region of host time (``train/forward``,
``attn/core``, ``serve/decode`` ...).  With no recording open, the
default, it returns one shared no-op context: no object is built, no
lock taken, no autograd node inserted and no device call made.  Inside
``with recording() as rec:`` every span stores its name, its start and
end on ``time.perf_counter_ns()``, the native id of its thread, its
parent (the span open on the same thread; on a thread with none open,
such as the autograd engine's in a backward pass, the latest-opened span
still open on another thread, which is the one that started the
backward pass, blocked inside it) and its attributes.  Spans stay in
memory; nothing is written until a reader asks
(``obs.chrome.span_events``, ``profile_session``).

The backward pass of a region runs on the autograd engine's thread,
outside any forward span.  :meth:`Span.enter` and :meth:`Span.exit` put
a pair of identity ``autograd.Function`` s around the region while a
recording is open and grad is on: the one on the region's output opens
``<name>.bwd`` in its backward, the one on all of the region's tensor
inputs closes it.  Under a checkpoint the region's forward span opens
again in the recompute, inside ``train/backward``.  A recording is
opened and closed between steps, so that a recompute inserts the same
markers as its forward pass did.

Counters live in the recording too: :meth:`Recording.add` sums host
integers (no sync); :meth:`Recording.max` keeps a running maximum as a
device tensor, read once, when the recording closes.  While a recording
is open a ``gc.callbacks`` hook records each collection as a
``host/gc`` span (``generation``).

The clock: the recording reads (``perf_counter_ns``, ``time_ns``) when
it opens and when it closes; :meth:`Recording.epoch_ns` maps a span's
times onto the epoch clock between the two.  Kineto stamps the host's
events on that clock (``ts`` in µs after the trace's
``baseTimeNanoseconds``), so a span lands on a profiler trace at
``(epoch_ns - baseTimeNanoseconds) / 1e3`` µs.
"""
from __future__ import annotations

import contextlib
import gc
import threading
import time

import torch

__all__ = ["span", "recording", "current", "Recording", "Span"]


class _NullSpan:
    """The span returned while no recording is open: enters and exits as
    a no-op and hands the region's tensors back as they are."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    @staticmethod
    def enter(*tensors):
        return tensors

    @staticmethod
    def exit(out):
        return out


NULL_SPAN = _NullSpan()
# the open recording, if any: spans and counters of the whole process go
# to it, as torch.profiler's ranges go to the open profiler
_OPEN: "Recording | None" = None


def current() -> "Recording | None":
    """The open recording, or None."""
    return _OPEN


def span(name: str, **attrs):
    """A context manager that records ``name`` (with ``attrs``) into the
    open recording; the shared no-op :data:`NULL_SPAN` when none is
    open."""
    rec = _OPEN
    if rec is None:
        return NULL_SPAN
    return Span(rec, name, attrs)


class Span:
    """One recorded span.  ``start`` and ``end`` are
    ``perf_counter_ns`` readings, ``tid`` the native thread id,
    ``parent`` the enclosing :class:`Span` or None."""

    __slots__ = ("rec", "name", "attrs", "start", "end", "tid", "parent",
                 "_bwd")

    def __init__(self, rec: "Recording", name: str, attrs: dict):
        self.rec, self.name, self.attrs = rec, name, attrs
        self.start = self.end = None
        self.tid = self.parent = None
        self._bwd = None                # the .bwd span's holder (enter)

    def __enter__(self):
        self.rec._open(self)
        return self

    def __exit__(self, *exc):
        self.rec._close(self)
        return False

    def enter(self, *tensors):
        """``tensors`` (tensors, or dicts, lists and tuples of them: the
        region's inputs) through an identity whose backward closes this
        region's ``.bwd`` span; returned in the same structure.  Leaves
        that need no gradient pass as they are."""
        if not torch.is_grad_enabled():
            return tensors
        flat: list = []
        _flatten(tensors, flat)
        if not flat:
            return tensors
        self._bwd = [None]
        marked = _Close.apply(self.rec, self._bwd, *flat)
        return _rebuild(tensors, iter(marked))

    def exit(self, out: torch.Tensor) -> torch.Tensor:
        """``out`` (the region's output) through an identity whose
        backward opens this region's ``.bwd`` span."""
        if self._bwd is None or not out.requires_grad:
            return out
        return _Open.apply(self.rec, self._bwd, self.name + ".bwd",
                           self.attrs, out)


def _flatten(t, out: list) -> None:
    if isinstance(t, torch.Tensor):
        if t.requires_grad:
            out.append(t)
    elif isinstance(t, dict):
        for v in t.values():
            _flatten(v, out)
    elif isinstance(t, (list, tuple)):
        for v in t:
            _flatten(v, out)


def _rebuild(t, marked):
    if isinstance(t, torch.Tensor):
        return next(marked) if t.requires_grad else t
    if isinstance(t, dict):
        return {k: _rebuild(v, marked) for k, v in t.items()}
    if isinstance(t, (list, tuple)):
        return type(t)(_rebuild(v, marked) for v in t)
    return t


class _Close(torch.autograd.Function):
    """Identity on a region's inputs; its backward, which runs once every
    gradient of the region has reached them, closes the ``.bwd`` span."""

    @staticmethod
    def forward(ctx, rec, bwd, *xs):
        ctx.set_materialize_grads(False)
        ctx.rec, ctx.bwd = rec, bwd
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *grads):
        s = ctx.bwd[0]
        if s is not None:
            ctx.bwd[0] = None
            ctx.rec._close(s)
        return (None, None) + grads


class _Open(torch.autograd.Function):
    """Identity on a region's output; its backward, the region's first,
    opens the ``.bwd`` span."""

    @staticmethod
    def forward(ctx, rec, bwd, name, attrs, out):
        ctx.set_materialize_grads(False)
        ctx.rec, ctx.bwd, ctx.name, ctx.attrs = rec, bwd, name, attrs
        return out.view_as(out)

    @staticmethod
    def backward(ctx, grad):
        if ctx.bwd[0] is None:
            s = Span(ctx.rec, ctx.name, ctx.attrs)
            ctx.rec._open(s)
            ctx.bwd[0] = s
        return None, None, None, None, grad


def _clock() -> tuple[int, int]:
    """(perf_counter_ns, time_ns) read together: the first taken midway
    between two readings around the second."""
    a = time.perf_counter_ns()
    w = time.time_ns()
    b = time.perf_counter_ns()
    return (a + b) // 2, w


class Recording:
    """What one ``with recording():`` saw: ``spans`` in the order they
    opened, ``counters`` (host sums; after the close also the device
    maxima, as floats) and ``clock``, the (perf_counter_ns, time_ns)
    pairs read at the open and at the close."""

    def __init__(self):
        self.spans: list[Span] = []
        self.counters: dict[str, float] = {}
        self.clock: list[tuple[int, int]] = []
        self._device: dict[str, torch.Tensor] = {}
        self._stacks: dict[int, list[Span]] = {}   # by thread ident
        self._tids: dict[int, int] = {}             # ident: native id
        self._lock = threading.Lock()
        self._gc: Span | None = None

    # -- spans ---------------------------------------------------------
    def _open(self, s: Span) -> None:
        ident = threading.get_ident()
        stack = self._stacks.get(ident)
        if stack is None:
            # the native id is a system call: read once a thread
            stack = self._stacks[ident] = []
            self._tids[ident] = threading.get_native_id()
        s.tid = self._tids[ident]
        s.parent = stack[-1] if stack else self._elsewhere(ident)
        self.spans.append(s)
        stack.append(s)
        s.start = time.perf_counter_ns()

    def _close(self, s: Span) -> None:
        s.end = time.perf_counter_ns()
        for stack in (self._stacks.get(threading.get_ident(), ()),
                      *self._stacks.values()):
            if stack and stack[-1] is s:
                stack.pop()
                return
            if s in stack:
                stack.remove(s)
                return

    def _elsewhere(self, ident: int) -> Span | None:
        """The latest-opened span still open on another thread."""
        best = None
        for t, stack in list(self._stacks.items()):
            if stack and t != ident and (
                    best is None or
                    (stack[-1].start or 0) > (best.start or 0)):
                best = stack[-1]
        return best

    def _on_gc(self, phase: str, info: dict) -> None:
        if phase == "start":
            self._gc = Span(self, "host/gc",
                            {"generation": info.get("generation")})
            self._open(self._gc)
        elif self._gc is not None:
            self._close(self._gc)
            self._gc = None

    # -- counters ------------------------------------------------------
    def add(self, name: str, n: int) -> None:
        """Add the host integer ``n`` to counter ``name``."""
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + n

    def max(self, name: str, value: torch.Tensor) -> None:
        """Keep in counter ``name`` the running maximum of ``value`` (a
        0-dim device tensor), on the device until the close."""
        value = value.detach().float()
        with self._lock:
            old = self._device.get(name)
            self._device[name] = value if old is None else \
                torch.maximum(old, value.to(old.device))

    # -- the clock -------------------------------------------------------
    def epoch_ns(self, pc_ns: float) -> float:
        """``pc_ns`` (a ``perf_counter_ns`` reading) on the epoch clock,
        interpolated between the open's and the close's pairs."""
        (p0, w0), (p1, w1) = self.clock[0], self.clock[-1]
        rate = (w1 - w0) / (p1 - p0) if p1 > p0 else 1.0
        return w0 + (pc_ns - p0) * rate


@contextlib.contextmanager
def recording():
    """Open a recording, yield it, close it: the clock's second pair
    read, the device counters read (one sync), the gc hook removed.
    One recording is open at a time."""
    global _OPEN
    if _OPEN is not None:
        raise RuntimeError("a recording is already open")
    rec = Recording()
    rec.clock.append(_clock())
    gc.callbacks.append(rec._on_gc)
    _OPEN = rec
    try:
        yield rec
    finally:
        _OPEN = None
        gc.callbacks.remove(rec._on_gc)
        rec.clock.append(_clock())
        rec.counters.update({k: float(v) for k, v in rec._device.items()})
        rec._device.clear()
