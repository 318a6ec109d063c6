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

What runs under :func:`unseen` is counted but held by no one: the flop
counter counts its ops, each by its multiplier, while the listeners hear
none of its regions, collections or reads and the memory tracker tracks
none of its storages.  A kernel's ``meta`` rule uses it where the kernel
allocates less than the plain version it is counted as (the training
attention pair, ``kernels/flash_attention/train.py``).

The backward pass has its own such bytes.  An item that is a piece of a
``split``/``unbind`` (a block, a time step, a layer's weights) gets its
gradient in the backward pass, and autograd holds it until the split's
backward gathers every piece's gradient in one ``cat``/``stack``: the
unrolled loop holds one gradient a piece until then, the shortened one
only those of the pieces it read (it zero-fills the others' at the
gather).  While a listener is open, :class:`Steps` notes the pieces of a
split among the items it yields (a tensor, or in a tuple, list or dict)
and the region each is read in.  The middle item stands for items
1 .. n-2, whose backward passes the unrolled loop runs from the last to
the first: when the backward pass enters the middle item's region, the
pieces of items 2 .. n-2 have their gradients already.  So as the
backward pass first runs a node made in a region where a piece was read
(:func:`entering`, called by the listener before each op), the listeners
hear (``stand_in``) how many unread pieces that piece stands for: those
that follow it, up to the next piece read.  A split of which the loops
read one piece only is not a loop's split, and stands for nothing;
nothing is added to the autograd graph.
"""
from __future__ import annotations

import bisect
import contextlib
import functools
import threading

import torch

__all__ = ["steps", "Steps", "multiplier", "frozen", "on_meta",
           "fill_keys", "account", "entering", "add_listener",
           "remove_listener", "clear", "unseen", "is_unseen"]

_state = threading.local()
# regions of autograd sequence numbers, closed, sorted by ``lo``:
# (lo, hi, total multiplier); read during backward passes on any thread
_los: list[int] = []
_regions: list[tuple[int, int, int]] = []
_memo: dict[int, int] = {}
_listeners: list = []
_unseen = 0             # depth of the open ``unseen`` contexts, any thread
_counters: list = []
_lock = threading.Lock()
# split/unbind backward nodes whose pieces the loops read, by sequence
# number: (how many pieces, the pieces read); the reads made inside a
# region, by the region's first sequence number: [(node, piece, bytes)];
# the (node, piece) pairs whose stand-ins the listeners have heard; the
# regions of the reads not yet heard, as a tree (built when the backward
# pass first looks)
_GATHERS = ("SplitBackward0", "SplitWithSizesBackward0", "UnbindBackward0")
_read: dict[int, tuple[int, set]] = {}
_pending: dict[int, list] = {}
_heard: set = set()
_tree: list = []


def on_meta(*tensors) -> bool:
    """Whether every tensor given is on the ``meta`` device."""
    return bool(tensors) and all(
        isinstance(t, torch.Tensor) and t.device.type == "meta"
        for t in tensors)


def _audience() -> list:
    """The listeners to tell: none inside :func:`unseen`."""
    return [] if _unseen else list(_listeners)


@contextlib.contextmanager
def unseen():
    """Count what runs inside, and let no listener see it (see the module
    docstring).  Not thread-local: a backward pass run inside may run on
    the autograd engine's threads."""
    global _unseen
    _unseen += 1
    try:
        yield
    finally:
        _unseen -= 1


def is_unseen() -> bool:
    return _unseen > 0


def _stack() -> list:
    s = getattr(_state, "stack", None)
    if s is None:
        s = _state.stack = []
    return s


def _opened() -> list:
    """The first sequence numbers of the open regions, innermost last
    (None for a region opened with gradients off)."""
    s = getattr(_state, "opened", None)
    if s is None:
        s = _state.opened = []
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
    audience = _audience()
    for obj in audience:
        obj.region_enter(n)
    _stack().append(n)
    _opened().append(lo)
    try:
        yield
    finally:
        _stack().pop()
        _opened().pop()
        for obj in audience:
            obj.region_exit(n, lo)
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
        # a sequence (a range, a model's layers) is indexed as the loop
        # runs, so that a shortened loop makes only the items it runs
        self.items = items if hasattr(items, "__getitem__") and \
            hasattr(items, "__len__") and not isinstance(items, dict) \
            else list(items)
        self.n = len(self.items)
        self.short = self.n > 3 and on_meta(like)

    def __iter__(self):
        if not self.short:
            for i in range(self.n):
                yield _noted(self.items[i])
            return
        yield _noted(self.items[0])
        with _region(self.n - 2):
            yield _noted(self.items[1])
        yield _noted(self.items[-1])

    def fill(self, outs: list) -> list:
        """The per-item outputs of the items run (three when short, or
        two where the first item outputs nothing) as a list of ``n`` (or
        ``n - 1``): the middle one's detached views stand for the items
        it represents (a tree of tensors is viewed leaf by leaf)."""
        if not self.short:
            return outs
        head, (mid, last) = outs[:-2], outs[-2:]
        for obj in _audience():
            obj.collected(_leaves(mid), self.n - 3)
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


def _leaves(tree) -> list:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return []


def _detached(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach()
    if isinstance(tree, dict):
        return {k: _detached(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_detached(v) for v in tree)
    return tree


def _noted(item):
    """``item``, each piece of a split in it (a tensor, or in a tuple,
    list or dict) noted as read (see the module docstring) while a
    listener is open."""
    if not _audience():
        return item
    if isinstance(item, torch.Tensor):
        _note(item)
    elif isinstance(item, dict):
        for v in item.values():
            _noted(v)
    elif isinstance(item, (tuple, list)):
        for x in item:
            _noted(x)
    return item


def _note(t) -> None:
    """Note ``t`` as read, when it is a ``meta`` piece of a split of more
    than one piece and requires grad, and the region it is read in; a
    recompute's reads (a checkpointed function's forward pass run again
    in the backward pass) make nothing the backward pass runs, and are
    not noted."""
    node = t.grad_fn
    if node is None or node.name() not in _GATHERS or not on_meta(t) \
            or not torch.is_grad_enabled() \
            or torch._C._current_autograd_node() is not None:
        return
    n = len(node._input_metadata)
    if n < 2:
        return
    _read.setdefault(node._sequence_nr(), (n, set()))[1].add(t.output_nr)
    opened = _opened()
    if opened and opened[-1] is not None:
        _pending.setdefault(opened[-1], []).append(
            (node, t.output_nr, t.numel() * t.element_size()))
        _tree.clear()


def _stands_for(node, slot: int) -> int:
    """How many pieces of ``node``'s split no loop read that piece
    ``slot`` stands for: those after it up to the next piece read, and,
    for the first piece read, those before it; none where one piece
    only was read."""
    n, read = _read[node._sequence_nr()]
    if len(read) < 2:
        return 0
    stop = min((j for j in read if j > slot), default=n)
    return stop - slot - 1 + (slot if slot == min(read) else 0)


def _pending_tree() -> list:
    """The regions of the reads not yet heard: their first and last
    sequence numbers, sorted, and each one's innermost enclosing one's
    index (-1 for none); regions nest or are disjoint."""
    los = sorted(_pending)
    his, parent, open_ = [], [], []
    for lo in los:
        i = bisect.bisect_left(_los, lo)
        hi = _regions[i][1] if i < len(_los) and _los[i] == lo else lo - 1
        while open_ and his[open_[-1]] < lo:
            open_.pop()
        parent.append(open_[-1] if open_ else -1)
        open_.append(len(his))
        his.append(hi)
    return [los, his, parent]


def entering() -> None:
    """Called by a listener before each op.  When the backward pass runs
    a node made in a region where pieces were read, the first time, the
    listeners hear each piece's stand-ins (``stand_in``)."""
    if not _pending or _unseen:
        return
    node = torch._C._current_autograd_node()
    if node is None:
        return
    seq = node._sequence_nr()
    if not _tree:
        _tree.extend(_pending_tree())
    los, his, parent = _tree
    i = bisect.bisect_right(los, seq) - 1
    while i >= 0:
        if his[i] >= seq:
            lo = los[i]
            for split, slot, nbytes in _pending.pop(lo, ()):
                key = (split._sequence_nr(), slot)
                if key in _heard:
                    continue
                _heard.add(key)
                copies = _stands_for(split, slot)
                if copies:
                    for obj in list(_listeners):
                        obj.stand_in(nbytes, split, copies, lo)
        i = parent[i]


def account(fn, *args, **kwargs) -> None:
    """Let every open flop counter (``launch.flopcount.FlopCounter``)
    count ``fn(*args, **kwargs)``: the plain version of a kernel called on
    ``meta``, which launches nothing and returns what the kernel
    allocates; nothing runs when no counter is open."""
    for counter in list(_counters):
        counter.count_plain(fn, args, kwargs)


def add_listener(obj) -> None:
    """``obj.region_enter(n)`` and ``obj.region_exit(n, lo)`` are called
    as each region opens and closes (``lo``: its first sequence number,
    None with gradients off), ``obj.collected(tensors, copies)`` as
    :meth:`Steps.fill` makes ``copies`` stand-ins of the middle item's
    outputs, and ``obj.stand_in(nbytes, node, copies, lo)`` as the
    backward pass enters the region ``lo`` where a piece of ``nbytes`` of
    ``node``'s split was read, that stands for ``copies`` unread pieces
    until ``node`` runs."""
    _listeners.append(obj)


def remove_listener(obj) -> None:
    _listeners.remove(obj)


def clear() -> None:
    """Forget the closed regions (their nodes' backward passes are done)."""
    with _lock:
        _los.clear()
        _regions.clear()
        _memo.clear()
        _read.clear()
        _pending.clear()
        _heard.clear()
        _tree.clear()
