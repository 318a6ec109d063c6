"""Per-worker task queues in message-passing-buffer style (§3.2, §3.4, §3.5).

On the SCC each worker's task queue is an array of 32-byte-aligned descriptor
slots inside that worker's 8 KB on-chip MPB; the master writes descriptors
directly into remote slots (asynchronously, never interrupting the worker),
and the worker marks slots *completed* in place.  Slot reuse is the
completion signal — there are no interrupts and no locks, just the SPSC
discipline plus explicit fences.

This module reproduces that protocol faithfully as a bounded SPSC ring of
slots with the three states of the paper (EMPTY / READY / COMPLETED) and the
master-side "local index of the next available entry".  On the SCC the fences
are L1 invalidation (read) and write-combine-buffer flush (write); under
CPython the shared memory is coherent, so the fences are no-ops kept as
explicit markers — the DES (``sim.py``) charges their true costs.

The 8 KB MPB / 32 B lines give 512 lines per worker in hardware; descriptor
alignment to MPB cache lines avoids master/worker false sharing, which we
model with one descriptor per slot.
"""
from __future__ import annotations

import enum
import threading
from dataclasses import dataclass
from typing import Optional

from .graph import TaskDescriptor

__all__ = ["SlotState", "MPBQueue", "MPBChannel", "MPB_LINE_BYTES",
           "MPB_BYTES_PER_CORE", "DESC_BYTES", "DESCRIPTORS_PER_LINE",
           "lines_for"]

MPB_LINE_BYTES = 32          # one MPB cache line (§3.2)
MPB_BYTES_PER_CORE = 8192    # 8 KB of on-chip SRAM per core

# Dependence-protocol descriptor packing (§3.2): one region-run or grant
# descriptor is 16 bytes (array id + tile range, or a header plus packed
# predecessor ids), so two descriptors share each 32-byte MPB line.  The
# dependence manager, the DES, and the traffic predictor all count lines
# through :func:`lines_for`, which is what keeps predicted and measured
# line counts reconciled.
DESC_BYTES = 16
DESCRIPTORS_PER_LINE = MPB_LINE_BYTES // DESC_BYTES


def lines_for(slots: int) -> int:
    """MPB lines occupied by ``slots`` 16-byte descriptors (>= 1: even an
    empty envelope spends its header line)."""
    if slots <= 0:
        return 1
    return -(-slots // DESCRIPTORS_PER_LINE)


class SlotState(enum.Enum):
    EMPTY = 0
    READY = 1
    COMPLETED = 2


@dataclass
class _Slot:
    state: SlotState = SlotState.EMPTY
    task: Optional[TaskDescriptor] = None


class MPBQueue:
    """Bounded SPSC descriptor ring between the master and one worker.

    Master-side ops: :meth:`try_put` (enqueue a ready task into the next
    slot, collecting a completed descriptor if the slot holds one) and
    :meth:`collect_completed` (poll for finished tasks).  Worker-side ops:
    :meth:`next_ready` / :meth:`mark_completed`.
    """

    def __init__(self, worker_id: int, n_slots: int = 16):
        if n_slots < 1:
            raise ValueError("need at least one slot")
        self.worker_id = worker_id
        self.n_slots = n_slots
        self._slots = [_Slot() for _ in range(n_slots)]
        self._head = 0   # master's local index of the next entry to fill
        self._tail = 0   # worker's local index of the next entry to run
        # On SCC the protocol is lock-free via the SPSC discipline + fences.
        # A CPython lock stands in for per-line atomic visibility; the
        # protocol logic is unchanged.
        self._lock = threading.Lock()
        self._work_available = threading.Condition(self._lock)
        # instrumentation
        self.enq_count = 0
        self.full_rejections = 0

    # -- master side ---------------------------------------------------------
    def try_put(self, td: TaskDescriptor) -> tuple[bool, Optional[TaskDescriptor]]:
        """Append ``td`` at the master's next slot (§3.4).

        Returns ``(accepted, collected)``: ``collected`` is a completed
        descriptor that was reclaimed from the slot, if any.  If the slot is
        still READY (worker behind), the put is rejected and the master must
        either keep the task in its local ready queue (running mode) or try
        the next worker (polling mode).
        """
        with self._work_available:
            slot = self._slots[self._head]
            collected = None
            if slot.state is SlotState.COMPLETED:
                collected = slot.task
                slot.state = SlotState.EMPTY
                slot.task = None
            if slot.state is not SlotState.EMPTY:
                self.full_rejections += 1
                return False, collected
            slot.task = td
            slot.state = SlotState.READY
            td.worker = self.worker_id
            self._head = (self._head + 1) % self.n_slots
            self.enq_count += 1
            # master does NOT flush its write-combine buffer here (§3.5
            # optimization): the worker may observe the transition late,
            # which only causes it to poll again.
            self._work_available.notify()
            return True, collected

    def collect_completed(self) -> list[TaskDescriptor]:
        """Master poll (§3.4 polling mode, function ii): gather descriptors
        marked completed, freeing their slots for reuse.  Master invalidates
        its L1 before reading a worker's queue (read fence — no-op here)."""
        out = []
        with self._lock:
            for slot in self._slots:
                if slot.state is SlotState.COMPLETED:
                    out.append(slot.task)
                    slot.task = None
                    slot.state = SlotState.EMPTY
        return out

    # -- worker side ----------------------------------------------------------
    def next_ready(self, timeout: float | None = None) -> Optional[TaskDescriptor]:
        """Worker poll: invalidate L1 (read fence — no-op) then check the next
        slot in order.  Blocks up to ``timeout`` for work (the condvar stands
        in for the SCC's polling loop so this container's single CPU isn't
        burned spinning; the DES charges real polling costs)."""
        with self._work_available:
            slot = self._slots[self._tail]
            if slot.state is not SlotState.READY:
                self._work_available.wait(timeout)
                slot = self._slots[self._tail]
            if slot.state is SlotState.READY:
                self._tail = (self._tail + 1) % self.n_slots
                return slot.task
            return None

    def mark_completed(self, td: TaskDescriptor) -> None:
        """Worker marks the descriptor's slot completed, then flushes its
        write-combine buffer (write fence — no-op here) so the master
        observes it (§3.5)."""
        with self._lock:
            for slot in self._slots:
                if slot.task is td:
                    slot.state = SlotState.COMPLETED
                    return
        raise RuntimeError(f"descriptor {td!r} not found in MPB "
                           f"{self.worker_id}")

    # -- introspection ----------------------------------------------------------
    def occupancy(self) -> int:
        with self._lock:
            return sum(1 for s in self._slots
                       if s.state is not SlotState.EMPTY)


class MPBChannel:
    """Bounded SPSC message ring for small typed control messages.

    The dependence managers (``depman.py``) exchange ``dep_query`` /
    ``dep_grant`` / ``release`` messages with the master over these rings
    — the same MPB transport the descriptor queues use (§3.2), but
    carrying a few 32-byte lines of metadata per message instead of a
    task descriptor.

    Unlike :class:`MPBQueue` this ring is lock-free even under CPython:
    the discipline is strictly SPSC — exactly one producer thread and one
    consumer thread per ring (under ``dep_pump="sync"`` both roles run on
    the master; under ``dep_pump="threaded"`` the consumer is the home's
    pump thread).  ``try_send`` refuses when full (the producer must let
    the consumer progress — backpressure, never blocking); ``recv_all``
    drains in FIFO order one ``popleft`` at a time, so a message appended
    concurrently by the producer is either drained this call or intact
    for the next (a snapshot-then-clear drain would drop it).  The GIL
    plus ``deque``'s atomic append/popleft stand in for the SCC's
    per-line fences.  The DES charges ``SCCParams.mpb_write_s`` per MPB
    *line*, with several descriptors packed per line
    (:data:`DESCRIPTORS_PER_LINE`).
    """

    def __init__(self, name: str, n_slots: int = 16):
        if n_slots < 1:
            raise ValueError("need at least one slot")
        self.name = name
        self.n_slots = n_slots
        from collections import deque
        self._ring: deque = deque()
        # instrumentation (mirrors MPBQueue's counters)
        self.sends = 0
        self.full_stalls = 0

    def try_send(self, msg) -> bool:
        """Producer: append one message, or refuse when the ring is full
        (the caller pumps the consumer and retries — SPSC backpressure)."""
        if len(self._ring) >= self.n_slots:
            self.full_stalls += 1
            return False
        self._ring.append(msg)
        self.sends += 1
        return True

    def recv_all(self) -> list:
        """Consumer: drain every pending message in FIFO order.

        Pops one slot at a time so it is safe against a producer thread
        appending concurrently (SPSC: this method has exactly one
        caller thread per ring); a message appended mid-drain waits for
        the next call, which also bounds one drain at the ring depth."""
        ring = self._ring
        n = len(ring)
        if not n:
            return []
        pop = ring.popleft
        return [pop() for _ in range(n)]

    def __len__(self) -> int:
        return len(self._ring)
