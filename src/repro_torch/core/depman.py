"""Home-sharded dependence management: per-home managers over MPB channels.

The paper keeps dependence analysis on one master core and pays for it in
master-side spawn cost (§3.3, §5); the related work attacks exactly that
bottleneck by distributing the task manager (Bosch et al., *Asynchronous
Runtime with Distributed Manager*) and by hierarchical dependency-aware
scheduling (Lyberis et al., *Myrmics*).  This module is that refactor:
:class:`ShardedDependenceManager` splits the global
:class:`~.deps.DependenceAnalyzer` into N :class:`HomeManager` s
— one per block home, the same ``placement.device_assignment`` regions
``DeviceTileStore`` already uses — each owning the block metadata for its
home and admitting the slice of a task's footprint that touches its
region.

Transport is paper-faithful, in two layers:

* **Logical messages** — ``dep_query`` (master -> manager: one per-home
  footprint slice), ``dep_grant`` (manager -> master: the predecessors
  found) and ``release`` (master -> manager: completion fan-out).  These
  are what ``dep_messages`` counts and what the obs layer's ``dep_msg``
  events record — one per logical descriptor, independent of batching.
* **Envelopes on the wire** — the way the paper packs several 16-byte
  descriptors per 32-byte MPB line (§3.2), the master coalesces the
  logical descriptors bound for one home into multi-descriptor
  :class:`DepMessage` envelopes of up to ``dep_batch_lines`` MPB lines.
  An envelope flushes when it fills, at every blocking sync point, and
  at wave boundaries (``MasterScheduler.release_all`` /
  :meth:`ShardedDependenceManager.flush`); a manager answers each
  query-carrying envelope with exactly one grant envelope.  Envelope
  boundaries are decided by the master from the logical stream and the
  configuration alone — never by consumer timing — so the
  ``dep_batches`` / ``dep_lines`` counters are deterministic and
  bit-equal between the sync and threaded pump modes (the JAX
  package's ``sim.predict_dep_traffic`` replays the same policy over
  :attr:`ShardedDependenceManager.traffic_log` and must agree).

Pumping comes in two modes (``RuntimeConfig.dep_pump``):

* ``"sync"`` — the master services manager inboxes inline at each
  blocking sync point, through the same single non-reentrant
  :meth:`~ShardedDependenceManager._service` loop the threads run.  A
  send under backpressure never services mid-send; it drains grants and
  lets the consumer run (the historical ``_post``-pumps-inside-drain
  reentrancy hazard is structurally gone).
* ``"threaded"`` — each home's manager runs on a pump worker thread
  (homes map ``home % n_threads``); the master is a pure producer that
  posts envelopes and drains grant rings, never executing manager logic
  inline.  Admission is *split-phase*: :meth:`analyze_begin` posts the
  footprint slices, :meth:`admit_finish` collects completed admissions
  in spawn order; the blocking :meth:`analyze` is begin+finish of one
  task.  Quiescing (:meth:`quiesce`) flushes every buffer and waits
  until each manager has consumed exactly the envelopes the master
  posted and every grant is absorbed; :meth:`shutdown` quiesces, stops
  and joins the threads.  Grant-ring overflow still raises (never
  drops): the master drains a home's grants before every post to it, so
  outstanding grant envelopes never exceed the ring depth in a correct
  run, and the manager-side raise is the protocol tripwire.

Determinism is unchanged from the sync path: ``TaskDescriptor.state``
transitions (the ``is_complete`` reads the managers filter on) happen
only on the master, and the master never lets a transition overlap an
in-flight query — blocking callers are blocked, the split-phase driver
retires tasks only after ``admit_finish`` drained every grant.  Per-home
envelope order is master post order, so manager metadata evolves
identically run to run; the grant union is a set, insensitive to arrival
order.  The determinism pins in ``tests/test_torch_depman.py`` and the
60-seed differential replay in ``tests/test_torch_differential*.py``
hold central, sharded-sync and sharded-threaded to identical schedules,
numerics and dependence counts, and hold them to the JAX package's
manager count for count.

Readiness is sharded too: the manager keeps one ready deque per home
(owner-computes — a task parks at the home of its first output block),
``MasterScheduler.drain_ready`` round-robins over them, and the staged
wave builder consumes the per-home ready sets level by level.
"""
from __future__ import annotations

import os
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import TYPE_CHECKING, Iterable

from ..obs.tracker import NULL_TRACKER

from .blocks import coerce_mode
from .deps import BlockId
from .mpb import DESCRIPTORS_PER_LINE, MPBChannel, lines_for

if TYPE_CHECKING:  # pragma: no cover
    from .graph import TaskDescriptor

__all__ = ["DepMessage", "HomeManager", "ShardedDependenceManager",
           "grant_slots"]

_MSG_KINDS = ("dep_query", "dep_grant", "release")

#: predecessor task ids packed per 16-byte grant descriptor (one header
#: descriptor carries the task correlation; ids pack 4 per slot after)
GRANT_IDS_PER_SLOT = 4


def grant_slots(n_deps: int) -> int:
    """16-byte descriptor slots of one ``dep_grant`` payload: a header
    naming the admitted task plus ``n_deps`` predecessor ids packed
    :data:`GRANT_IDS_PER_SLOT` per slot."""
    return 1 + (n_deps + GRANT_IDS_PER_SLOT - 1) // GRANT_IDS_PER_SLOT


@dataclass(slots=True)
class DepMessage:
    """One envelope on an MPB ring: a batch of packed descriptors.

    * ``dep_batch`` (master -> manager): ``payload`` is a list of
      logical descriptors ``(kind, task, items)`` with ``kind`` in
      ``("dep_query", "release")`` and ``items`` the per-home region
      runs of ``(reads, writes, blocks)``.
    * ``dep_grant`` (manager -> master): ``payload`` is a list of
      ``(task, deps)`` pairs — one per query descriptor of the envelope
      being answered (a manager replies once per query-carrying
      envelope).
    """
    kind: str
    home: int
    task: "TaskDescriptor | None"
    payload: object = None


class _Pending:
    """Master-side split-phase admission record: grants still owed."""

    __slots__ = ("task", "remaining", "deps")

    def __init__(self, task: "TaskDescriptor", remaining: int):
        self.task = task
        self.remaining = remaining
        self.deps: set = set()


class HomeManager:
    """One home's dependence manager: owns the block metadata for every
    block homed in its region and admits footprint slices independently.

    The metadata is the BDDT per-block ordering state (last writer +
    readers since that write, §3.3) kept as two plain dicts — leaner
    than the central analyzer's per-block objects, which is where the
    sharded admission path wins back its messaging overhead.

    Under ``dep_pump="threaded"`` every mutating method runs on the
    home's single pump thread (the counters below are single-writer);
    the master only reads, and only after :meth:`ShardedDependenceManager.quiesce`.
    """

    __slots__ = ("home", "_writer", "_readers", "deps_found",
                 "admissions", "ready", "processed", "busy_s")

    def __init__(self, home: int):
        self.home = home
        self._writer: dict[BlockId, "TaskDescriptor"] = {}
        self._readers: dict[BlockId, list["TaskDescriptor"]] = {}
        self.deps_found = 0             # dependences this manager granted
        self.admissions = 0             # footprint slices admitted
        self.processed = 0              # envelopes consumed (quiesce bound)
        self.busy_s = 0.0               # wall seconds spent servicing
        # per-home ready deque (owner-computes): what drain_ready and the
        # staged wave builder consume
        self.ready: deque["TaskDescriptor"] = deque()

    @property
    def live_blocks(self) -> int:
        """Blocks with live ordering state (leak check surface)."""
        return len(self._writer) + sum(1 for k in self._readers
                                       if k not in self._writer)

    def admit(self, task: "TaskDescriptor",
              items: list) -> set["TaskDescriptor"]:
        """Process one ``dep_query``: the fused collect-then-publish walk
        over this home's slice.  Each region run is visited in argument
        order, so a block touched by several modes of one task sees the
        same sequence of states the central analyzer's two passes produce
        (self-dependences are filtered exactly like the central walk)."""
        writer = self._writer
        readers = self._readers
        deps: set[TaskDescriptor] = set()
        add = deps.add
        wget = writer.get
        rget = readers.get
        for r, w, blocks in items:
            if w:
                for block in blocks:
                    lw = wget(block)
                    if lw is not None and lw is not task \
                            and not lw.is_complete:
                        add(lw)                      # RAW / WAW
                    rl = rget(block)
                    if rl is not None:
                        for t in rl:
                            if t is not task and not t.is_complete:
                                add(t)               # WAR
                        del readers[block]
                    writer[block] = task
            else:
                for block in blocks:
                    lw = wget(block)
                    if lw is not None and lw is not task \
                            and not lw.is_complete:
                        add(lw)                      # RAW
                    rl = rget(block)
                    if rl is None:
                        readers[block] = [task]
                    elif task not in rl:
                        rl.append(task)
        self.admissions += 1
        self.deps_found += len(deps)
        return deps

    def sync(self, blocks: Iterable[BlockId],
             writers_only: bool) -> set["TaskDescriptor"]:
        """The ``tasks_touching`` slice for this home (wait_on support)."""
        found: set[TaskDescriptor] = set()
        for block in blocks:
            w = self._writer.get(block)
            if w is not None and not w.is_complete:
                found.add(w)
            if not writers_only:
                for r in self._readers.get(block, ()):
                    if not r.is_complete:
                        found.add(r)
        return found

    def forget(self, task: "TaskDescriptor", items: list) -> None:
        """Process one ``release``: drop the task's references so block
        state stays O(live tasks) — entries with no live writer and no
        live readers are deleted outright."""
        writer = self._writer
        readers = self._readers
        for _r, _w, blocks in items:
            for block in blocks:
                if writer.get(block) is task:
                    del writer[block]
                rl = readers.get(block)
                if rl is not None:
                    try:
                        rl.remove(task)
                    except ValueError:
                        pass
                    if not rl:
                        del readers[block]


class _PumpWorker(threading.Thread):
    """One pump thread servicing a fixed set of homes.

    Runs the shared :meth:`ShardedDependenceManager._service` loop over
    its homes until stopped; parks on its wake event when every inbox is
    empty (the master sets the event after each post).  Exceptions are
    handed to the master through ``parent._pump_errors`` — the master
    re-raises at its next wait point instead of hanging."""

    def __init__(self, parent: "ShardedDependenceManager",
                 homes: list[int], idx: int):
        super().__init__(name=f"dep-pump-{idx}", daemon=True)
        self.parent = parent
        self.homes = homes
        self.wake = threading.Event()
        self.idle_waits = 0

    def run(self) -> None:  # pragma: no cover - exercised via runtime
        parent = self.parent
        homes = self.homes
        inbox = parent.inbox
        stop = parent._stop
        try:
            while True:
                busy = False
                for h in homes:
                    busy |= parent._service(h)
                if busy:
                    continue
                if stop.is_set():
                    # final sweep already found every inbox empty
                    break
                self.wake.clear()
                # re-check after clearing: a post between the sweep and
                # the clear would otherwise be a lost wakeup
                if any(len(inbox[h]) for h in homes):
                    continue
                self.idle_waits += 1
                if parent.obs.enabled:
                    parent.obs.emit("pump_idle", manager=homes[0],
                                    waits=self.idle_waits)
                self.wake.wait(0.05)
        except BaseException as e:  # noqa: BLE001 - handed to the master
            parent._pump_errors.append(e)
            with parent._cv:
                parent._grants_flag = True
                parent._cv.notify_all()


class ShardedDependenceManager:
    """N per-home managers behind the central analyzer's protocol.

    Drop-in for :class:`~.deps.DependenceAnalyzer` at every
    runtime touch point (``analyze`` / ``tasks_touching`` /
    ``forget_completed`` / the ``blocks_walked`` / ``deps_found``
    counters), plus the sharded extras the scheduler and wave builder
    consume: per-home ready deques (:meth:`push_ready` /
    :meth:`pop_ready`) and owner routing (:meth:`owner_of`).

    Routing needs each block's home, which lives on its ``BlockArray``;
    the runtime calls :meth:`register_array` for every array it
    registers, so the router is one dict lookup per footprint block.
    The admitted slice of each live task is kept (master-side, O(live
    tasks) — the same lifetime as its descriptor) so completion fan-out
    reuses it instead of re-partitioning the footprint.

    ``batch_lines`` sets the envelope capacity in MPB lines
    (``batch_lines * DESCRIPTORS_PER_LINE`` descriptor slots);
    ``batch_lines=1`` disables coalescing — every logical descriptor
    travels alone, reproducing the pre-batching wire traffic exactly
    (``dep_batches == dep_messages``).  ``pump`` selects ``"sync"`` or
    ``"threaded"`` (see the module docstring); ``pump_threads`` caps the
    thread count (default: one per home, or ``REPRO_DEPMAN_THREADS``
    when set).
    """

    def __init__(self, n_managers: int = 4, channel_slots: int = 16,
                 obs=NULL_TRACKER, batch_lines: int = 1,
                 pump: str = "sync", pump_threads: int | None = None,
                 record_traffic: bool = False):
        if n_managers < 1:
            raise ValueError("need at least one manager")
        if pump not in ("sync", "threaded"):
            raise ValueError(f"pump must be 'sync' or 'threaded', "
                             f"got {pump!r}")
        self.n_managers = n_managers
        self.obs = obs
        self.pump = pump
        self.batch_lines = max(1, int(batch_lines))
        self.managers = [HomeManager(h) for h in range(n_managers)]
        # MPB-style SPSC rings: one inbox (master -> manager) and one
        # grant channel (manager -> master) per home
        self.inbox = [MPBChannel(f"dep/home{h}", channel_slots)
                      for h in range(n_managers)]
        self.grants = [MPBChannel(f"grant/home{h}", channel_slots)
                       for h in range(n_managers)]
        self._homes: dict[int, dict] = {}    # array_id -> tile home map
        self._live_parts: dict = {}          # td -> admitted slices
        # region -> per-home block runs.  Task programs name the same
        # footprint regions over and over (the same tiles every
        # iteration), so the routing walk runs once per distinct region
        # and every later admission is a dict hit.  Invalidated when an
        # array (re)registers, which is when home maps change.
        self._route_cache: dict = {}
        # -- outgoing line batcher (master-side; all counters here are
        # master-written only, so they need no synchronization) ---------
        self._batch_slots = self.batch_lines * DESCRIPTORS_PER_LINE
        self._out: list[list] = [[] for _ in range(n_managers)]
        self._out_slots = [0] * n_managers
        self._posted = [0] * n_managers      # envelopes sent per home
        # -- split-phase admission state (master-side) -------------------
        self._pending: deque[_Pending] = deque()
        self._pending_by_task: dict = {}
        # -- counters ----------------------------------------------------
        # logical messages: queries/releases counted at enqueue, grants
        # counted as the master absorbs them — all master-side, so the
        # totals are exact after any sync point in either pump mode
        self._msgs_posted = 0
        self._grants_received = 0
        self._batches_posted = 0
        self._lines_posted = 0
        self._batches_granted = 0
        self._lines_granted = 0
        # blocks walked during admission routing — mirrors the central
        # analyzer's count so stats stay comparable across managers
        self.blocks_walked = 0
        self._deps_found = 0                 # unioned, master-side
        self._rr_home = 0                    # drain_ready round-robin
        # optional logical-traffic recording for the sim-side
        # reconciliation (the JAX package's ``sim.predict_dep_traffic``
        # replays it)
        self.traffic_log: list | None = [] if record_traffic else None
        self.traffic_deps: dict[int, int] = {}   # query id -> grant deps
        self._rec_next_qid = 0
        self._rec_qid: dict = {}                 # td -> {home: query id}
        # -- threaded pump machinery -------------------------------------
        self._stop = threading.Event()
        self._cv = threading.Condition()
        self._grants_flag = False
        self._pump_errors: list[BaseException] = []
        self._threads: list[_PumpWorker] = []
        self._thread_of: list[_PumpWorker] = []
        if pump == "threaded":
            n_threads = pump_threads
            if n_threads is None:
                try:
                    n_threads = int(os.environ.get(
                        "REPRO_DEPMAN_THREADS", "0")) or n_managers
                except ValueError:
                    n_threads = n_managers
            n_threads = max(1, min(int(n_threads), n_managers))
            by_thread: list[list[int]] = [[] for _ in range(n_threads)]
            for h in range(n_managers):
                by_thread[h % n_threads].append(h)
            self._threads = [_PumpWorker(self, homes, i)
                             for i, homes in enumerate(by_thread)]
            self._thread_of = [None] * n_managers  # type: ignore
            for t in self._threads:
                for h in t.homes:
                    self._thread_of[h] = t
            for t in self._threads:
                t.start()

    # -- routing -------------------------------------------------------------
    def register_array(self, ba) -> None:
        """Learn an array's block -> home map (called at registration,
        after ``placement.assign_homes`` ran)."""
        self._homes[ba.array_id] = ba.home
        self._route_cache.clear()

    def _route(self, region) -> tuple:
        """Per-home block runs of one region: ``(n_blocks, ((home,
        blocks), ...))``, cached by the region's identity (array +
        tile ranges)."""
        key = (region.array.array_id, region.ranges)
        hit = self._route_cache.get(key)
        if hit is None:
            ids = region.block_ids
            hmap = self._homes.get(region.array.array_id)
            if not hmap:
                runs: dict[int, list] = {0: list(ids)}
            else:
                n = self.n_managers
                hget = hmap.get
                runs = {}
                for block in ids:
                    h = hget(block[1], 0) % n
                    blocks = runs.get(h)
                    if blocks is None:
                        runs[h] = [block]
                    else:
                        blocks.append(block)
            hit = (len(ids), tuple(runs.items()))
            self._route_cache[key] = hit
        return hit

    def _partition(self, task: "TaskDescriptor") -> dict[int, list]:
        """Split a footprint into per-home slices of ``(reads, writes,
        blocks)`` region runs, in argument order (the order
        :meth:`HomeManager.admit` replays)."""
        route_get = self._route_cache.get
        route = self._route
        parts: dict[int, list] = {}
        walked = 0
        for mode in task.args:
            region = mode.region
            hit = route_get((region.array.array_id, region.ranges)) \
                or route(region)
            walked += hit[0]
            r, w = mode.READS, mode.WRITES
            for h, blocks in hit[1]:
                lst = parts.get(h)
                if lst is None:
                    parts[h] = [(r, w, blocks)]
                else:
                    lst.append((r, w, blocks))
        self.blocks_walked += walked
        return parts

    # -- the wire: batching, flushing, servicing ------------------------------
    def _enqueue(self, home: int, kind: str, task, items: list) -> None:
        """Buffer one logical descriptor for ``home``; flush on envelope
        capacity (ring pressure — the deterministic trigger: it depends
        on the logical stream and ``batch_lines`` alone)."""
        slots = max(1, len(items))
        if self._out_slots[home] + slots > self._batch_slots \
                and self._out[home]:
            self._flush_home(home)
        self._out[home].append((kind, task, items))
        self._out_slots[home] += slots
        self._msgs_posted += 1
        if self.traffic_log is not None:
            qid = None
            if kind == "dep_query":
                # query ids correlate grant payload sizes positionally
                # (descriptor pools recycle task ids, so tids can't key)
                qid = self._rec_next_qid
                self._rec_next_qid += 1
                self._rec_qid.setdefault(task, {})[home] = qid
            self.traffic_log.append(("desc", home, kind, slots, qid))
        if self.obs.enabled:
            self.obs.emit("dep_msg", manager=home, msg=kind, count=1)
        if self.batch_lines <= 1:
            # batching off: every descriptor travels alone (the
            # pre-batching wire behavior, envelope == logical message)
            self._flush_home(home)

    def _flush_home(self, home: int) -> None:
        """Seal and post one home's buffered envelope.  Backpressure
        never services inline mid-send: the master drains grants (which
        is what frees a correct consumer) and, threaded, waits for the
        pump thread — the single non-reentrant service loop is only ever
        entered from :meth:`_service_all` (sync) or the pump threads."""
        descs = self._out[home]
        if not descs:
            return
        slots = self._out_slots[home]
        self._out[home] = []
        self._out_slots[home] = 0
        # drain this home's grants *before* posting: keeps outstanding
        # grant envelopes <= unanswered query envelopes <= ring depth,
        # so the manager-side overflow raise cannot fire in a correct
        # run (it stays as the protocol tripwire, never a drop)
        self._absorb(home)
        env = DepMessage("dep_batch", home, None, descs)
        ch = self.inbox[home]
        threaded = self.pump == "threaded"
        while not ch.try_send(env):
            if threaded:
                self._wait_for_grants()
                # absorb EVERY home, not just this one: a pump thread
                # stalled on some other home's full grant ring is what
                # may be keeping this home's inbox from draining
                self._absorb_all()
            else:
                self._service(home)
                self._absorb(home)
        self._posted[home] += 1
        self._batches_posted += 1
        nlines = lines_for(slots)
        self._lines_posted += nlines
        if self.traffic_log is not None:
            self.traffic_log.append(("flush", home))
        if self.obs.enabled:
            self.obs.emit("dep_batch", manager=home, direction="post",
                          descriptors=len(descs), lines=nlines)
        if threaded:
            self._thread_of[home].wake.set()

    def flush(self) -> None:
        """Flush every home's buffered envelope (wave boundaries,
        barriers, explicit sync points)."""
        if self.traffic_log is not None:
            # every flush-all is a policy-visible sync point; the
            # sim-side replay (``predict_dep_traffic``) flushes its model
            # buffers here too
            self.traffic_log.append(("sync",))
        for home in range(self.n_managers):
            if self._out[home]:
                self._flush_home(home)

    def _service(self, home: int) -> bool:
        """THE pump loop: drain one manager's inbox, admitting queries
        and dropping released metadata; answer each query-carrying
        envelope with one grant envelope.  Non-reentrant by
        construction — posting paths never call it while a drain is in
        progress, and in threaded mode only the home's pump thread runs
        it.  Returns True when any envelope was consumed."""
        envs = self.inbox[home].recv_all()
        if not envs:
            return False
        t0 = time.perf_counter()
        mgr = self.managers[home]
        grants_ring = self.grants[home]
        for env in envs:
            pairs = []
            for kind, task, items in env.payload:
                if kind == "dep_query":
                    pairs.append((task, mgr.admit(task, items)))
                else:                                # release
                    mgr.forget(task, items)
            if pairs:
                grant = DepMessage("dep_grant", home, None, pairs)
                if not grants_ring.try_send(grant):
                    if self.pump != "threaded":
                        # sync protocol invariant: the master drains
                        # grants before every post AND after every
                        # service, so the ring can never refill past
                        # capacity — a full ring means a lost
                        # dependence set
                        raise RuntimeError(
                            f"dep_grant ring overflow on home {home}")
                    # threaded: the master absorbs this home's grants
                    # on its next post / wait / sync cycle, but may lag
                    # while backpressuring on a different home — wake
                    # it and wait for ring space (backpressure, never a
                    # drop; the master's wait loops absorb ALL homes)
                    while not grants_ring.try_send(grant):
                        with self._cv:
                            self._grants_flag = True
                            self._cv.notify_all()
                        if self._stop.is_set():
                            raise RuntimeError(
                                f"dep_grant ring overflow on home {home}"
                                f" at shutdown")
                        time.sleep(10e-6)
            mgr.processed += 1
        mgr.busy_s += time.perf_counter() - t0
        if self.pump == "threaded":
            # signal any consumption, not just grants: the master's
            # backpressure and quiesce waits also ride this flag (a
            # release-only envelope frees ring space too)
            with self._cv:
                self._grants_flag = True
                self._cv.notify_all()
        return True

    def _absorb(self, home: int) -> None:
        """Master-side: drain one home's grant ring into the pending
        admission records (grants count as logical messages here, so
        every counter stays master-written)."""
        envs = self.grants[home].recv_all()
        if not envs:
            return
        obs_on = self.obs.enabled
        by_task = self._pending_by_task
        for env in envs:
            slots = 0
            for task, got in env.payload:
                rec = by_task.get(task)
                if rec is not None:
                    rec.remaining -= 1
                    if got:
                        rec.deps |= got
                n_deps = len(got)
                slots += grant_slots(n_deps)
                self._grants_received += 1
                if self.traffic_log is not None:
                    homes_of = self._rec_qid.get(task)
                    if homes_of is not None:
                        self.traffic_deps[homes_of.pop(home)] = n_deps
                        if not homes_of:
                            del self._rec_qid[task]
                if obs_on:
                    self.obs.emit("manager_admit", manager=home,
                                  task=task.tid, deps=n_deps,
                                  depth=len(self.inbox[home]))
                    self.obs.emit("dep_msg", manager=home,
                                  msg="dep_grant", count=1)
            self._batches_granted += 1
            nlines = lines_for(slots)
            self._lines_granted += nlines
            if obs_on:
                self.obs.emit("dep_batch", manager=home,
                              direction="grant",
                              descriptors=len(env.payload), lines=nlines)

    def _absorb_all(self) -> None:
        for home in range(self.n_managers):
            self._absorb(home)

    def _check_pump(self) -> None:
        if self._pump_errors:
            err = self._pump_errors[0]
            raise RuntimeError("dependence pump thread failed") from err

    def _wait_for_grants(self, timeout: float = 0.01) -> None:
        """Park until a pump thread signals grant (or envelope)
        progress; bounded wait so a protocol bug surfaces as a slow
        test, not a hang."""
        self._check_pump()
        with self._cv:
            if not self._grants_flag:
                self._cv.wait(timeout)
            self._grants_flag = False

    def _collect_admitted(self) -> list:
        """Pop fully-granted admissions off the left of the pending
        queue — spawn order, the order ``analyze_begin`` was called."""
        out = []
        pend = self._pending
        by_task = self._pending_by_task
        while pend and pend[0].remaining == 0:
            rec = pend.popleft()
            del by_task[rec.task]
            self._deps_found += len(rec.deps)
            out.append((rec.task, rec.deps))
        return out

    # -- split-phase admission -------------------------------------------------
    def analyze_begin(self, task: "TaskDescriptor") -> None:
        """Post a task's footprint slices as ``dep_query`` descriptors
        (non-blocking producer side).  The caller must not complete any
        task (no ``is_complete`` transition) until :meth:`admit_finish`
        returned this task — that ordering is the bit-identity
        contract."""
        parts = self._partition(task)
        self._live_parts[task] = parts
        rec = _Pending(task, len(parts))
        self._pending.append(rec)
        self._pending_by_task[task] = rec
        for home, items in parts.items():
            self._enqueue(home, "dep_query", task, items)

    def admit_finish(self) -> list:
        """Flush buffered queries and wait until *every* pending
        admission is granted; returns ``(task, deps)`` pairs in spawn
        order.  Sync mode services the managers inline here (the only
        sync-mode service site besides quiesce); threaded mode just
        drains grant rings while the pump threads work."""
        self.flush()
        if self.pump == "threaded":
            out: list = []
            while self._pending:
                self._absorb_all()
                done = self._collect_admitted()
                if done:
                    out.extend(done)
                elif self._pending:
                    self._wait_for_grants()
            return out
        self._service_all()
        self._absorb_all()
        return self._collect_admitted()

    def _service_all(self) -> None:
        for home in range(self.n_managers):
            if len(self.inbox[home]):
                self._service(home)

    # -- the DependenceAnalyzer protocol --------------------------------------
    def analyze(self, task: "TaskDescriptor") -> set["TaskDescriptor"]:
        """Blocking admission of one task: route the footprint to its
        home managers, wait for the grant union.  Exactly
        ``analyze_begin`` + ``admit_finish`` of a single task."""
        self.analyze_begin(task)
        pairs = self.admit_finish()
        # single caller discipline: blocking analyze never overlaps
        # another pending admission, so the pair list is exactly ours
        return pairs[-1][1]

    def tasks_touching(self, blocks, mode: str = "in") \
            -> set["TaskDescriptor"]:
        """Same rules as the central analyzer's region sync, routed by
        home (``mode="in"`` waits for writers; ``"out"``/``"inout"`` for
        readers too).  Quiesces first: buffered releases are applied and
        the pump threads drained, so the metadata read is current and
        race-free."""
        self.quiesce()
        mode = coerce_mode(mode)
        n = self.n_managers
        homes = self._homes
        per_home: dict[int, list] = {}
        for block in blocks:
            hmap = homes.get(block[0])
            h = (hmap.get(block[1], 0) if hmap else 0) % n
            per_home.setdefault(h, []).append(block)
        found: set[TaskDescriptor] = set()
        for h, blks in per_home.items():
            found |= self.managers[h].sync(blks,
                                           writers_only=(mode == "in"))
        return found

    def forget_completed(self, task: "TaskDescriptor") -> None:
        """Completion fan-out: one ``release`` descriptor per involved
        home, carrying the slice admitted at initiation.  Buffered — the
        wire envelope goes out with the next flush (wave boundary, ring
        pressure, or sync point); correctness never depends on release
        timing because admission filters on ``is_complete``."""
        parts = self._live_parts.pop(task, None)
        if parts is None:                # never admitted here (defensive)
            return
        for home, items in parts.items():
            self._enqueue(home, "release", task, items)

    # -- quiesce / shutdown ----------------------------------------------------
    def quiesce(self) -> None:
        """Flush every buffer and wait until each manager consumed
        exactly the envelopes the master posted and every grant was
        absorbed.  Requires no admissions outstanding (collect them with
        :meth:`admit_finish` first)."""
        if self._pending:
            raise RuntimeError("quiesce with admissions outstanding — "
                               "drain admit_finish() first")
        self.flush()
        if self.pump == "threaded":
            posted = self._posted
            managers = self.managers
            while True:
                self._absorb_all()
                self._check_pump()
                if all(managers[h].processed == posted[h]
                       for h in range(self.n_managers)):
                    self._absorb_all()
                    break
                self._wait_for_grants()
        else:
            self._service_all()
            self._absorb_all()

    def shutdown(self) -> None:
        """Quiesce, stop and join the pump threads (idempotent; sync
        mode only flushes)."""
        if not self._pump_errors:
            self.quiesce()
        self._stop.set()
        for t in self._threads:
            t.wake.set()
        for t in self._threads:
            t.join(timeout=5.0)
        self._check_pump()

    # -- stats ---------------------------------------------------------------
    @property
    def dep_messages(self) -> int:
        """Logical protocol messages — one per ``dep_query`` /
        ``dep_grant`` / ``release`` descriptor, independent of how they
        were packed into envelopes (bit-compatible with the pre-batching
        counter)."""
        return self._msgs_posted + self._grants_received

    @property
    def dep_batches(self) -> int:
        """Envelopes actually sent over the rings, both directions —
        strictly fewer than ``dep_messages`` whenever batching is on."""
        return self._batches_posted + self._batches_granted

    @property
    def dep_lines(self) -> int:
        """Total 32-byte MPB lines those envelopes occupied (what the
        DES charges; ``predict_dep_traffic`` must reproduce it)."""
        return self._lines_posted + self._lines_granted

    @property
    def pump_wall_s(self) -> float:
        """Wall seconds spent inside manager servicing (per-home
        single-writer accumulators: the pump threads' busy time under
        ``threaded``, the master's inline service time under
        ``sync``)."""
        return sum(m.busy_s for m in self.managers)

    @property
    def idle_waits(self) -> list[int]:
        """Times each pump thread parked on its wake event with every
        inbox empty (empty under ``"sync"``); a lost wakeup shows here as
        a slow run, not a hang."""
        return [t.idle_waits for t in self._threads]

    @property
    def deps_found(self) -> int:
        """Unioned master-side count — matches the central analyzer (a
        predecessor granted by two managers counts once)."""
        return self._deps_found

    @property
    def admissions(self) -> list[int]:
        """Per-manager admitted footprint slices (the acceptance-visible
        admission counts; also emitted as ``manager_admit`` events)."""
        return [m.admissions for m in self.managers]

    @property
    def live_blocks(self) -> int:
        """Blocks with live ordering state, summed over homes (quiesces
        first so buffered releases are applied and no pump thread is
        mutating the dicts mid-read)."""
        self.quiesce()
        return sum(m.live_blocks for m in self.managers)

    # -- per-home readiness (owner-computes) -----------------------------------
    def owner_of(self, td: "TaskDescriptor") -> int:
        """A task parks at the home of its first output block (the
        owner-computes rule the sharded executor dispatches by)."""
        for m in td.args:
            if m.WRITES:
                region = m.region
                hmap = self._homes.get(region.array.array_id)
                if hmap:
                    return hmap.get(region.tile_indices[0], 0) \
                        % self.n_managers
                return 0
        return 0

    def push_ready(self, td: "TaskDescriptor", front: bool = False) -> None:
        q = self.managers[self.owner_of(td)].ready
        if front:
            q.appendleft(td)
        else:
            q.append(td)

    @property
    def ready_count(self) -> int:
        return sum(len(m.ready) for m in self.managers)

    def pop_ready(self) -> "TaskDescriptor | None":
        """Round-robin over the per-home ready deques (fair drain; no
        home starves behind a deep neighbor)."""
        n = self.n_managers
        for i in range(n):
            h = (self._rr_home + i) % n
            q = self.managers[h].ready
            if q:
                self._rr_home = (h + 1) % n
                return q.popleft()
        return None
