"""The master core's scheduling logic (§3.4) and task release (§3.6).

The master is in one of two modes:

* **running** — executing the main program.  A spawned, immediately-ready
  task is appended to some worker's MPB queue; if that worker's next slot is
  full the task goes to the master's local ready queue and the main program
  continues — the master *never blocks at a spawn*.
* **polling** — entered at synchronization points (barriers, end of program)
  or when the descriptor pool is exhausted.  The master then (i) drains the
  ready queue, (ii) polls worker queues for completed descriptors, and
  (iii) releases completed tasks' dependencies from the completion queue.

Release is *lazy* (§3.6): completed tasks are collected into the completion
queue and their dependents' counters are only decremented when the master
idles or needs resources, keeping release off the critical path.
"""
from __future__ import annotations

import random
from typing import Callable, Sequence

from ..obs.tracker import NULL_TRACKER

from .deps import DependenceAnalyzer
from .graph import DescriptorPool, TaskDescriptor, TaskGraph, TaskState
from .mpb import MPBQueue

__all__ = ["MasterScheduler", "POLICIES"]


def _rr_policy(sched: "MasterScheduler", td: TaskDescriptor) -> Sequence[int]:
    """Round-robin over workers, starting after the last one used."""
    n = len(sched.queues)
    start = (sched._rr_last + 1) % n
    sched._rr_last = start
    return [(start + i) % n for i in range(n)]


def _locality_policy(sched: "MasterScheduler", td: TaskDescriptor) -> Sequence[int]:
    """Prefer the worker whose cache most recently produced one of this
    task's input blocks (tile-affinity; the paper's locality discussion in
    §4.1/§6 — tasks with good cache locality scale best)."""
    votes: dict[int, int] = {}
    for mode in td.args:
        if not mode.READS:
            continue
        for block in mode.region.block_ids:
            w = sched.block_last_worker.get(block)
            if w is not None:
                votes[w] = votes.get(w, 0) + 1
    order = sorted(votes, key=votes.get, reverse=True)
    rest = [w for w in _rr_policy(sched, td) if w not in votes]
    return order + rest


def _random_policy(sched: "MasterScheduler", td: TaskDescriptor) -> Sequence[int]:
    order = list(range(len(sched.queues)))
    sched._rng.shuffle(order)
    return order


POLICIES: dict[str, Callable] = {
    "round_robin": _rr_policy,
    "locality": _locality_policy,
    "random": _random_policy,
}

# the canonical choice list lives in api.SchedulingPolicy; this registry
# must implement exactly that list, no more, no less
from .api import SCHEDULING_POLICIES  # noqa: E402  (needs POLICIES above)

assert set(POLICIES) == set(SCHEDULING_POLICIES), \
    "scheduler.POLICIES drifted from api.SchedulingPolicy"


class MasterScheduler:
    """Drives the four task stages over a set of per-worker MPB queues."""

    obs = NULL_TRACKER     # set by TaskRuntime; channel = worker id

    def __init__(self, queues: list[MPBQueue], graph: TaskGraph,
                 pool: DescriptorPool, analyzer: DependenceAnalyzer,
                 policy: str = "round_robin", seed: int = 0):
        self.queues = queues
        self.graph = graph
        self.pool = pool
        self.analyzer = analyzer
        self.policy = POLICIES[policy]
        # sharded dependence manager: ready tasks park in per-home deques
        # owned by the managers (owner-computes); central path keeps the
        # single master-side ready queue
        self._ready_mgr = analyzer if hasattr(analyzer, "push_ready") \
            else None
        # sharded dependence manager: buffered release descriptors are
        # flushed at wave boundaries (end of release_all) — cached here
        # because release_all sits on the polling hot loop
        self._dep_flush = getattr(analyzer, "flush", None)
        self.block_last_worker: dict = {}
        self._rr_last = -1
        self._rng = random.Random(seed)
        # stats
        self.polling_rounds = 0
        self.tasks_scheduled = 0
        # live per-worker in-flight depth, maintained unconditionally
        # (the tracker's ``queue_depths()`` mirrors this only when a
        # tracker is attached); the serving admission controller reads
        # it to bound in-flight work without requiring observability on
        self._depths = [0] * len(queues)

    def queue_depths(self) -> dict[int, int]:
        """Current in-flight tasks per worker MPB ring (dispatched,
        not yet collected) — same shape the obs tracker reports."""
        return {w: d for w, d in enumerate(self._depths) if d}

    # -- running-mode scheduling (§3.4 first half) ---------------------------
    def schedule_running(self, td: TaskDescriptor) -> None:
        """Try exactly one worker (the policy's first choice); on rejection
        park the task in the local ready queue and return — the main program
        resumes immediately."""
        order = self.policy(self, td)
        wid = order[0]
        accepted, collected = self.queues[wid].try_put(td)
        if collected is not None:
            self._collect(collected)
        if accepted:
            self.tasks_scheduled += 1
            self._note_placement(td, wid)
            self._depths[wid] += 1
            if self.obs.enabled:
                self.obs.queue(wid, +1)
        else:
            self._park_ready(td)

    def _park_ready(self, td: TaskDescriptor, front: bool = False) -> None:
        """Park a ready task: in its home manager's deque under the
        sharded manager, else in the master's local ready queue."""
        if self._ready_mgr is not None:
            self._ready_mgr.push_ready(td, front=front)
        elif front:
            self.graph.ready.appendleft(td)
        else:
            self.graph.ready.append(td)

    # -- polling-mode scheduling (§3.4 second half) ----------------------------
    def schedule_polling(self, td: TaskDescriptor) -> bool:
        """Try every worker in policy order; if all queues are full, release
        one completed task and retry once (the paper releases and retries
        the *first* task)."""
        for attempt in range(2):
            for wid in self.policy(self, td):
                accepted, collected = self.queues[wid].try_put(td)
                if collected is not None:
                    self._collect(collected)
                if accepted:
                    self.tasks_scheduled += 1
                    self._note_placement(td, wid)
                    self._depths[wid] += 1
                    if self.obs.enabled:
                        self.obs.queue(wid, +1)
                    return True
            if attempt == 0:
                self.poll_workers()
                if not self.release_one():
                    # nothing completed yet; caller decides whether to spin
                    return False
        return False

    def _note_placement(self, td: TaskDescriptor, wid: int) -> None:
        for mode in td.outputs:
            for block in mode.region.block_ids:
                self.block_last_worker[block] = wid

    # -- polling-mode functions (i)-(iii) ----------------------------------------
    def drain_ready(self) -> None:
        """(i) schedule tasks from the ready queue(s).  Under the sharded
        dependence manager this drains the per-home deques round-robin
        (``pop_ready``); centrally it drains the master's local queue."""
        mgr = self._ready_mgr
        if mgr is not None:
            n = mgr.ready_count
            for _ in range(n):
                td = mgr.pop_ready()
                if td is None:
                    break
                if not self.schedule_polling(td):
                    mgr.push_ready(td, front=True)
                    break
            return
        n = len(self.graph.ready)
        for _ in range(n):
            if not self.graph.ready:
                break
            td = self.graph.ready.popleft()
            if not self.schedule_polling(td):
                self.graph.ready.appendleft(td)
                break

    def poll_workers(self) -> int:
        """(ii) discover descriptors marked completed; move them to the
        completion queue."""
        found = 0
        for q in self.queues:
            for td in q.collect_completed():
                self._collect(td)
                found += 1
        return found

    def _collect(self, td: TaskDescriptor) -> None:
        self.graph.mark_executed(td)
        self.graph.completion.append(td)
        # staged/sequential tds never went through an MPB ring (worker is
        # None); only host-dispatched tasks decrement a worker channel
        if td.worker is not None:
            self._depths[td.worker] -= 1
            if self.obs.enabled:
                self.obs.queue(td.worker, -1)

    def release_one(self) -> bool:
        """(iii) release one completed task's dependencies (lazy, §3.6)."""
        if not self.graph.completion:
            return False
        td = self.graph.completion.popleft()
        for ready in self.graph.release(td):
            self._park_ready(ready)
        self.analyzer.forget_completed(td)
        self.pool.release(td)
        return True

    def release_all(self) -> None:
        """Drain the completion queue, then flush the dependence
        manager's buffered release descriptors — the wave-boundary
        flush of the line batcher.  Grant arrival may be asynchronous
        under ``dep_pump="threaded"``, but the wave order stays pinned:
        admissions complete in spawn order before any task here was
        marked executed, so the release stream (and therefore the
        batcher's flush points) is identical across pump modes."""
        while self.release_one():
            pass
        if self._dep_flush is not None:
            self._dep_flush()

    # -- the polling loop itself --------------------------------------------------
    def polling_step(self) -> None:
        """One iteration of the master's polling mode."""
        self.polling_rounds += 1
        self.drain_ready()
        self.poll_workers()
        self.release_all()
