"""Collective and memory statistics of a dry run (the JAX package's
``launch/hlo_stats.py``).

The reference parses a compiled program's HLO text: every all-reduce,
all-gather, reduce-scatter, all-to-all and collective-permute, its
result shape and replica-group size, each multiplied by the trip counts
of the ``while`` loops around it.  PyTorch emits no HLO, and the port's
mesh is single-controller: what crosses between logical devices is the
exchanges it counts, and ``dist.record_exchanges`` records each as
``(kind, result_bytes, group_size, times)`` while a step runs.
:func:`collective_stats` reads those records by the reference's ring
model, per device:

* ``operand_bytes`` — the "sum of operand sizes": the result R for an
  all-reduce, all-to-all or collective-permute, R / G for an all-gather,
  R * G for a reduce-scatter;
* ``link_bytes`` — the bytes a device sends over its links in a ring:
  all-reduce 2 (G - 1) / G R, all-gather and all-to-all (G - 1) / G R,
  reduce-scatter (G - 1) R, collective-permute R.

Eager execution records an exchange once per execution, so a loop's
trip count is already in the records; where a ``meta`` trace runs a
loop's body once for several items, ``times`` carries the count (the
reference's ``_multipliers``).  The HLO text walk itself (the regexes,
``_computations``, ``_multipliers``) has no counterpart.

:func:`memory_stats` gives the reference's keys from what a ``meta``
trace measures (``launch.dryrun``): the inputs' and outputs' bytes by
logical device, and :class:`LiveBytes`, a ``TorchDispatchMode`` that
follows the storage of every tensor the step's operators make (weak
references; bytes = ``nbytes()``) and keeps the peak of their sum.
"""
from __future__ import annotations

import weakref
from collections import defaultdict
from dataclasses import dataclass, field

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from .. import metatrace

__all__ = ["CollectiveStats", "collective_stats", "memory_stats",
           "LiveBytes"]


@dataclass
class CollectiveStats:
    counts: dict = field(default_factory=lambda: defaultdict(int))
    operand_bytes: dict = field(default_factory=lambda: defaultdict(float))
    link_bytes: dict = field(default_factory=lambda: defaultdict(float))

    @property
    def total_operand_bytes(self) -> float:
        return float(sum(self.operand_bytes.values()))

    @property
    def total_link_bytes(self) -> float:
        return float(sum(self.link_bytes.values()))

    def to_dict(self) -> dict:
        return {
            "counts": dict(self.counts),
            "operand_bytes": {k: float(v)
                              for k, v in self.operand_bytes.items()},
            "link_bytes": {k: float(v) for k, v in self.link_bytes.items()},
            "total_operand_bytes": self.total_operand_bytes,
            "total_link_bytes": self.total_link_bytes,
        }


def collective_stats(records) -> CollectiveStats:
    """The ring model over exchange records, each ``(kind, result_bytes,
    group_size)`` or ``(kind, result_bytes, group_size, times)``."""
    stats = CollectiveStats()
    for rec in records:
        kind, result_bytes, g = rec[:3]
        _accumulate(stats, kind, result_bytes, g,
                    rec[3] if len(rec) > 3 else 1)
    return stats


def _accumulate(stats: CollectiveStats, kind: str, result_bytes: float,
                g: int, m_exec: float) -> None:
    stats.counts[kind] += m_exec
    if kind == "all-reduce":
        op = result_bytes
        link = 2.0 * (g - 1) / max(g, 1) * result_bytes
    elif kind == "all-gather":
        op = result_bytes / max(g, 1)
        link = (g - 1) / max(g, 1) * result_bytes
    elif kind == "reduce-scatter":
        op = result_bytes * g
        link = (g - 1) * result_bytes
    elif kind == "all-to-all":
        op = result_bytes
        link = (g - 1) / max(g, 1) * result_bytes
    elif kind == "collective-permute":
        op = result_bytes
        link = result_bytes
    else:
        raise ValueError(f"unknown collective kind {kind!r}")
    stats.operand_bytes[kind] += op * m_exec
    stats.link_bytes[kind] += link * m_exec


def memory_stats(*, argument_size_in_bytes: int, output_size_in_bytes: int,
                 alias_size_in_bytes: int, temp_size_in_bytes: int) -> dict:
    """The reference's keys (``compiled.memory_analysis()``'s) from a
    trace's sizes: no code is generated, and a device's total is its
    arguments, outputs and temporaries less what the outputs alias."""
    out = {"generated_code_size_in_bytes": 0,
           "argument_size_in_bytes": int(argument_size_in_bytes),
           "output_size_in_bytes": int(output_size_in_bytes),
           "alias_size_in_bytes": int(alias_size_in_bytes),
           "temp_size_in_bytes": int(temp_size_in_bytes)}
    out["per_device_total_bytes"] = (
        out["argument_size_in_bytes"] + out["output_size_in_bytes"]
        + out["temp_size_in_bytes"] - out["alias_size_in_bytes"])
    return out


class _Virtual:
    """Bytes standing for the items a shortened loop skipped, alive until
    the ``count`` storages of the item that ran are freed and, where
    those are freed in the backward pass before it has left the item's
    region (its first sequence number ``lo``), until it has; ``held``:
    of them, those that stand in for unread pieces' gradients too, and
    ``then``: the (split, bytes) stand-ins to count once they are
    freed."""
    __slots__ = ("nbytes", "count", "held", "then", "lo", "dropped")

    def __init__(self, nbytes: int, count: int, lo: int | None = None):
        self.nbytes, self.count, self.lo = nbytes, count, lo
        self.held, self.then = 0, []
        self.dropped = False


class LiveBytes(TorchDispatchMode):
    """The bytes of the storages the operators under it make, alive at
    each moment, and their peak (``peak``); ``live`` is the current sum.
    A storage an op's output shares with one of its inputs (a view, an
    in-place or ``out=`` op) is not new.  Storages that exist before the
    mode is entered are not counted.

    Under a shortened loop (``metatrace.steps``) the item that ran stands
    for ``n`` items: what it left alive (the live bytes at its end less
    those at its start: caches, saved activations) is counted ``n - 1``
    more times until everything it made and left alive is freed, but an
    output the loop collects (``metatrace``'s ``collected``) carries its
    own ``n - 1`` copies, freed with it.  Its peak inside is taken once,
    as each item's would be.  In the backward pass a piece of a split
    read in a region stands for the unread pieces after it
    (``stand_in``): from when the backward pass enters that region, their
    gradients are counted until the split's backward has gathered them,
    and the zeros that backward makes in their place are not.  While the
    region's own leftovers live on, the larger of the two is counted:
    the unrolled loop frees one item's leftovers as it makes the next
    one's gradients, from the last item to the first.  So the region's
    leftovers, freed in the backward pass before it reaches the region
    (the last item's backward frees the middle one's output), are counted
    until it has left the region: the unrolled loop frees the skipped
    items' leftovers one by one inside that stretch, and the item's own
    peak there meets the most of them.  What runs under
    ``metatrace.unseen`` is not tracked."""

    def __init__(self):
        super().__init__()
        self.live = 0
        self.peak = 0
        self._order = 0
        self._alive: dict[int, list] = {}      # id -> [nbytes, order, virt]
        self._regions: list[tuple[int, int]] = []
        # a region's first sequence number -> its leftovers' stand-in
        self._virtual_of: dict[int, _Virtual] = {}
        # split backward node's sequence number -> [bytes stood in, zeros
        # still to make]
        self._standing: dict[int, list] = {}
        # stand-ins whose storages are freed, counted until the backward
        # pass leaves their region
        self._deferred: list[_Virtual] = []

    def __enter__(self):
        metatrace.add_listener(self)
        return super().__enter__()

    def __exit__(self, *exc):
        metatrace.remove_listener(self)
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if metatrace.is_unseen():
            return func(*args, **kwargs)
        if self._deferred:
            self._leave()
        metatrace.entering()
        out = func(*args, **kwargs)
        if self._standing and func is torch.ops.aten.zeros.default and \
                self._zero_fill():
            return out
        outs = [t for t in tree_flatten(out)[0]
                if isinstance(t, torch.Tensor)]
        if outs:
            seen = {id(t.untyped_storage())
                    for t in tree_flatten((args, kwargs))[0]
                    if isinstance(t, torch.Tensor)}
            for t in outs:
                self._track(t.untyped_storage(), seen)
        return out

    def _zero_fill(self) -> bool:
        """Whether these zeros take an unread piece's place in a split's
        backward (already counted as the piece standing in for it)."""
        node = torch._C._current_autograd_node()
        rec = None if node is None else \
            self._standing.get(node._sequence_nr())
        if rec is None or rec[1] == 0:
            return False
        rec[1] -= 1
        return True

    def _add(self, n: int) -> None:
        self.live += n
        self.peak = max(self.peak, self.live)

    def _track(self, storage, seen: set) -> None:
        key = id(storage)
        n = storage.nbytes()
        if key in seen or key in self._alive or n == 0:
            return
        self._order += 1
        self._alive[key] = [n, self._order, []]
        weakref.finalize(storage, self._free, key)
        self._add(n)

    def _free(self, key: int) -> None:
        rec = self._alive.pop(key, None)
        if rec is None:
            return
        self.live -= rec[0]
        for v in rec[2]:
            v.count -= 1
            if v.count == 0:
                self._release(v)

    def _release(self, v: _Virtual) -> None:
        """``v``'s storages are freed: drop it, or, in the backward pass
        at or above its region, once the pass has left the region (at the
        latest when the pass ends)."""
        node = torch._C._current_autograd_node()
        if v.lo is None or node is None or node._sequence_nr() < v.lo:
            self._drop(v)
            return
        if not self._deferred:
            torch.autograd.Variable._execution_engine.queue_callback(
                self._flush)
        self._deferred.append(v)

    def _leave(self) -> None:
        node = torch._C._current_autograd_node()
        if node is None:
            self._flush()
            return
        seq = node._sequence_nr()
        for v in [v for v in self._deferred if seq < v.lo]:
            self._deferred.remove(v)
            self._drop(v)

    def _flush(self) -> None:
        while self._deferred:
            self._drop(self._deferred.pop())

    def _drop(self, v: _Virtual) -> None:
        """``v`` freed: the stand-ins it held are counted now."""
        v.dropped = True
        self.live -= v.nbytes
        for seq, n in v.then:
            rec = self._standing.get(seq)
            if rec is not None:
                rec[0] += n
                self._add(n)

    # metatrace listener
    def region_enter(self, n: int) -> None:
        self._regions.append((self.live, self._order))

    def region_exit(self, n: int, lo: int | None) -> None:
        live0, order0 = self._regions.pop()
        grown = self.live - live0
        if grown <= 0 or n <= 1:
            return
        members = []
        for key in reversed(self._alive):
            rec = self._alive[key]
            if rec[1] <= order0:
                break
            members.append(rec)
        if not members:
            return
        v = _Virtual((n - 1) * grown, len(members), lo)
        for rec in members:
            rec[2].append(v)
        self._add(v.nbytes)
        if lo is not None:
            self._virtual_of[lo] = v

    def collected(self, tensors, copies: int) -> None:
        for t in tensors:
            rec = self._alive.get(id(t.untyped_storage()))
            if rec is None:
                continue
            for i, v in enumerate(rec[2]):
                share = min(v.nbytes, copies * rec[0])
                v.nbytes -= share
                v.count -= 1
                if v.count == 0:
                    self._drop(v)
                rec[2][i] = _Virtual(share, 1)

    def stand_in(self, nbytes: int, node, copies: int, lo: int) -> None:
        seq = node._sequence_nr()
        rec = self._standing.get(seq)
        if rec is None:
            rec = self._standing[seq] = [0, 0]
            node.register_hook(lambda *_: self._gathered(seq))
        n = copies * nbytes
        v = self._virtual_of.get(lo)
        if v is not None and not v.dropped:
            held = min(n, v.nbytes - v.held)
            v.held += held
            v.then.append((seq, held))
            n -= held
        rec[0] += n
        rec[1] += copies
        self._add(n)

    def _gathered(self, seq: int) -> None:
        self.live -= self._standing.pop(seq)[0]
