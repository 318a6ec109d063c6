"""Count once, times the trip count: loops traced on ``meta`` tensors.

A dry run (``launch.dryrun``) traces a step on ``meta`` tensors: shapes
and dtypes, nothing computed, nothing launched.  Eagerly that trace
unrolls every Python loop, so a 40-layer model on a 16 x 16 mesh runs
each layer's attention once per mesh position, and each of those once
per query and key block.  The reference lowers each scan body once and
multiplies what it counts by the trip count (its flop counter's scan
rule, ``hlo_stats._multipliers``).  This module is that rule for the
port.

:func:`steps` walks the items of a loop.  When ``like`` is a ``meta``
tensor and the loop has more than three items it yields three of them:
the first, the second under a count multiplier of ``n - 2`` (standing
for items 1 .. n-2), and the last.  Every counter scales what it counts
by :func:`multiplier`: the flop counter (``launch.flopcount``), the
exchange recorder and byte counters (``dist``), the memory tracker
(``launch.hlo_stats``).  On any other tensor, and for three items or
fewer, every item is yielded and the multiplier stays 1: nothing
changes on real tensors, and there is no flag.

Why three and not one.  Iterations of a loop differ only at its ends:
the first reads the loop's initial carry (which requires no gradient),
the last hands its carry to what follows; the middle ones are alike.
Their gradients are exact too:

* every autograd node made while the multiplier is ``m`` keeps it: a
  region of :func:`steps` notes the sequence numbers of the nodes it
  makes, and during the backward pass the node the engine runs
  (``torch._C._current_autograd_node``) gives the multiplier of the
  innermost region that made it;
* the engine runs nodes in decreasing sequence order, so a tensor read
  by every iteration (q sliced per mesh position, a weight per time
  step) receives the last item's gradient first, then the middle's, then
  the first's: the additions that accumulate them run under the middle
  node (``n - 2`` of them) and the first (one), the ``n - 1`` additions
  of the unrolled loop;
* a checkpointed function recomputes its forward pass in the backward
  pass; :func:`frozen` wraps it so that the recompute counts with the
  multiplier it had when it was first called.

Outputs that a loop collects per item (chunks to concatenate, caches to
stack) are :meth:`Steps.fill`'ed: the middle item's output stands, as a
detached view, for the items it represents, so the concatenation has
its full shape and nothing more is allocated or differentiated.
Dicts a loop builds by item (by device) are completed by
:func:`fill_keys`.

Listeners (``add_listener``) see every region open and close, with its
trip count: the memory tracker uses that to count what an item leaves
alive once per item it stands for.
"""
from __future__ import annotations

import bisect
import contextlib
import functools
import threading

import torch

__all__ = ["steps", "Steps", "multiplier", "frozen", "on_meta",
           "fill_keys", "account", "add_listener", "remove_listener",
           "clear"]

_state = threading.local()
# regions of autograd sequence numbers, closed, sorted by ``lo``:
# (lo, hi, total multiplier); read during backward passes on any thread
_los: list[int] = []
_regions: list[tuple[int, int, int]] = []
_memo: dict[int, int] = {}
_listeners: list = []
_counters: list = []
_lock = threading.Lock()


def on_meta(*tensors) -> bool:
    """Whether every tensor given is on the ``meta`` device."""
    return bool(tensors) and all(
        isinstance(t, torch.Tensor) and t.device.type == "meta"
        for t in tensors)


def _stack() -> list:
    s = getattr(_state, "stack", None)
    if s is None:
        s = _state.stack = []
    return s


def _forward_multiplier() -> int:
    base = getattr(_state, "base", None)
    m = 1 if base is None else base
    for x in _stack():
        m *= x
    return m


def _node_multiplier(seq: int) -> int:
    """The total multiplier of the innermost region whose nodes include
    sequence number ``seq`` (1 outside every region)."""
    hit = _memo.get(seq)
    if hit is not None:
        return hit
    with _lock:
        i = bisect.bisect_right(_los, seq) - 1
        m = 1
        while i >= 0:
            lo, hi, total = _regions[i]
            if hi >= seq:
                m = total
                break
            i -= 1
    _memo[seq] = m
    return m


def multiplier() -> int:
    """How many times what runs now stands for: the product of the open
    regions' trip counts in the forward pass (or, inside a recompute,
    the one :func:`frozen` captured); in the backward pass, the
    multiplier the running autograd node was made under."""
    m = _forward_multiplier()
    if getattr(_state, "base", None) is None and _regions:
        node = torch._C._current_autograd_node()
        if node is not None:
            m *= _node_multiplier(node._sequence_nr())
    return m


def _next_seq() -> int:
    """The sequence number the next autograd node will get (a probe node
    is made, on ``meta``: no flops, no bytes)."""
    probe = torch.empty(0, device="meta", requires_grad=True).view(0)
    return probe.grad_fn._sequence_nr() + 1


@contextlib.contextmanager
def _region(n: int):
    """Everything inside counts ``n`` times (times the enclosing
    multiplier); the autograd nodes made inside remember it."""
    total = _forward_multiplier() * n
    grad = torch.is_grad_enabled()
    lo = _next_seq() if grad else None
    for obj in list(_listeners):
        obj.region_enter(n)
    _stack().append(n)
    try:
        yield
    finally:
        _stack().pop()
        for obj in list(_listeners):
            obj.region_exit(n)
        if grad:
            hi = _next_seq() - 2          # the closing probe took one
            if hi >= lo:
                with _lock:
                    i = bisect.bisect_right(_los, lo)
                    _los.insert(i, lo)
                    _regions.insert(i, (lo, hi, total))
                    _memo.clear()


@contextlib.contextmanager
def _override(m: int):
    """Count ``m`` times, the open regions set aside (a recompute)."""
    saved = (getattr(_state, "base", None), getattr(_state, "stack", None))
    _state.base, _state.stack = m, []
    try:
        yield
    finally:
        _state.base, _state.stack = saved


def frozen(fn):
    """``fn`` counting, whenever it runs, with the multiplier of the call
    that wraps it: what a checkpointed function needs, as its recompute
    runs in the backward pass, outside the regions it was called in."""
    m = _forward_multiplier()

    @functools.wraps(fn)
    def run(*args, **kwargs):
        with _override(m):
            return fn(*args, **kwargs)
    return run


class Steps:
    """The items of one loop (see the module docstring); iterate it.
    ``short`` says whether the shortcut is taken."""

    def __init__(self, items, like):
        self.items = list(items)
        self.n = len(self.items)
        self.short = self.n > 3 and on_meta(like)

    def __iter__(self):
        if not self.short:
            yield from self.items
            return
        yield self.items[0]
        with _region(self.n - 2):
            yield self.items[1]
        yield self.items[-1]

    def fill(self, outs: list) -> list:
        """The per-item outputs of the items run (three when short, or
        two where the first item outputs nothing) as a list of ``n`` (or
        ``n - 1``): the middle one's detached views stand for the items
        it represents (a tree of tensors is viewed leaf by leaf)."""
        if not self.short:
            return outs
        head, (mid, last) = outs[:-2], outs[-2:]
        return head + [mid] + [_detached(mid) for _ in range(self.n - 3)] \
            + [last]



def steps(items, like) -> Steps:
    """:class:`Steps` over ``items``, shortened when ``like`` is on
    ``meta``."""
    return Steps(items, like)


def fill_keys(out: dict, keys) -> dict:
    """``out`` (key -> value, for the items a shortened loop ran) with
    every key of ``keys``, in their order: a key not run maps to the
    value of one that was (every item's value has one shape)."""
    keys = list(keys)
    if len(out) == len(keys):
        return out
    some = next(iter(out.values()))
    return {k: out.get(k, some) for k in keys}


def _detached(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach()
    if isinstance(tree, dict):
        return {k: _detached(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_detached(v) for v in tree)
    return tree


def account(fn, *args, **kwargs) -> None:
    """Let every open flop counter (``launch.flopcount.FlopCounter``)
    count ``fn(*args, **kwargs)``: the plain version of a kernel called on
    ``meta``, which launches nothing and returns what the kernel
    allocates; nothing runs when no counter is open."""
    for counter in list(_counters):
        counter.count_plain(fn, args, kwargs)


def add_listener(obj) -> None:
    """``obj.region_enter(n)`` and ``obj.region_exit(n)`` are called as
    each region opens and closes."""
    _listeners.append(obj)


def remove_listener(obj) -> None:
    _listeners.remove(obj)


def clear() -> None:
    """Forget the closed regions (their nodes' backward passes are done)."""
    with _lock:
        _los.clear()
        _regions.clear()
        _memo.clear()
