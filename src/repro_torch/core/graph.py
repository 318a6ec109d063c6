"""Task descriptors, the task graph, and the master's queues (§3.2).

A spawned task becomes a :class:`TaskDescriptor` that moves through the four
runtime stages of the paper: initiation -> scheduling -> execution -> release.
The master keeps three structures in its private memory: the *ready queue*
(ready, unscheduled), the *completion queue* (executed, dependencies not yet
released) and the *task graph* (waiting on dependencies).  Descriptors come
from a bounded pre-allocated pool and are recycled at release (§3.3).
"""
from __future__ import annotations

import enum
import itertools
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Sequence

from .blocks import AccessMode, In, InOut, Out

__all__ = ["TaskState", "TaskDescriptor", "TaskGraph", "DescriptorPool",
           "normalize_outputs"]


def normalize_outputs(result, n_out: int, label) -> tuple:
    """Normalize a task function's return value into one value per
    OUT/INOUT argument, validating arity (the §3.5 execution contract,
    shared by ``TaskDescriptor.run`` and both StagedExecutor paths)."""
    if result is None:
        result = ()
    elif n_out == 1:
        result = (result,)
    if len(result) != n_out:
        raise RuntimeError(
            f"task {label}: fn returned {len(result)} values for "
            f"{n_out} OUT/INOUT arguments")
    return tuple(result)


class TaskState(enum.Enum):
    WAITING = "waiting"        # in the task graph, deps unresolved
    READY = "ready"            # ready queue (or MPB slot), not yet executed
    RUNNING = "running"        # being executed by a worker
    EXECUTED = "executed"      # completed, dependencies not yet released
    RELEASED = "released"      # dependencies released, descriptor recycled


@dataclass(eq=False)
class TaskDescriptor:
    """What the master writes into a worker's MPB slot: the spawned function,
    its arguments, a representation of the footprint, and any firstprivate
    values (OmpSs by-value parameters, copied in at initiation)."""
    tid: int
    fn: Callable
    args: tuple[AccessMode, ...]
    name: str = ""
    values: tuple = ()                 # firstprivate, in parameter order
    # dependence bookkeeping
    deps_remaining: int = 0
    dependents: list["TaskDescriptor"] = field(default_factory=list)
    preds: tuple["TaskDescriptor", ...] = ()   # discovered at initiation
    state: TaskState = TaskState.WAITING
    worker: int | None = None
    # instrumentation (used by tests, the DES and the benchmarks)
    spawn_order: int = 0
    exec_order: int | None = None
    # outputs captured at execution (references, not copies — nothing on
    # the task path writes a tensor in place), so a TaskFuture reads this
    # task's values even after later writers overwrite the region; None
    # until executed
    output_values: tuple | None = None
    # what the body raised on a host worker; the master re-raises it
    # from its next barrier, wait or pump (None on success)
    error: BaseException | None = None

    @property
    def is_complete(self) -> bool:
        return self.state in (TaskState.EXECUTED, TaskState.RELEASED)

    @property
    def inputs(self) -> tuple[AccessMode, ...]:
        return tuple(a for a in self.args if a.READS)

    @property
    def outputs(self) -> tuple[AccessMode, ...]:
        return tuple(a for a in self.args if a.WRITES)

    def run(self, materialize=None) -> None:
        """Task execution (§3.5): call the task function on materialized
        inputs; store the returned values into the OUT/INOUT regions.

        The function receives one array per READS argument, in argument
        order, then the firstprivate values in parameter order, and must
        return one array per WRITES argument, in argument order (a single
        array if there is exactly one).

        ``materialize`` (``region -> array``) overrides how READS regions
        assemble — host workers pass their pinned tile cache's reader so
        repeated reads of unchanged regions skip reassembly.
        """
        from .api import suspend_runtime_scope
        if materialize is None:
            in_vals = [a.region.materialize() for a in self.args if a.READS]
        else:
            in_vals = [materialize(a.region) for a in self.args if a.READS]
        with suspend_runtime_scope():
            result = self.fn(*in_vals, *self.values)
        outs = self.outputs
        result = normalize_outputs(result, len(outs), self.name or self.tid)
        for mode, value in zip(outs, result):
            mode.region.store(value)
        self.output_values = result

    def __repr__(self):
        return (f"<T{self.tid} {self.name or self.fn.__name__} "
                f"{self.state.value}>")


class DescriptorPool:
    """Pre-allocated descriptor pool (§3.3).  ``acquire`` fails when empty —
    the master must then enter polling mode and release completed tasks to
    recycle descriptors, exactly as in the paper."""

    def __init__(self, capacity: int = 4096):
        self.capacity = capacity
        self._live = 0
        self._tid = itertools.count()

    def acquire(self, fn, args, name="",
                values: tuple = ()) -> TaskDescriptor | None:
        if self._live >= self.capacity:
            return None
        self._live += 1
        return TaskDescriptor(tid=next(self._tid), fn=fn, args=tuple(args),
                              name=name, values=tuple(values))

    def release(self, td: TaskDescriptor) -> None:
        td.state = TaskState.RELEASED
        self._live -= 1

    @property
    def free(self) -> int:
        return self.capacity - self._live


class TaskGraph:
    """The master's view of all live tasks plus its ready/completion queues."""

    def __init__(self):
        self.ready: deque[TaskDescriptor] = deque()
        self.completion: deque[TaskDescriptor] = deque()
        self.waiting: set[TaskDescriptor] = set()
        self.n_unreleased = 0          # live tasks not yet released
        self.n_unexecuted = 0          # live tasks not yet executed
        self._exec_counter = itertools.count()

    # -- task initiation ----------------------------------------------------
    def insert(self, td: TaskDescriptor, deps: set[TaskDescriptor]) -> bool:
        """Add a new task given its discovered dependencies.  Returns True if
        the task is immediately ready."""
        self.n_unreleased += 1
        self.n_unexecuted += 1
        td.deps_remaining = len(deps)
        # spawn-order the dependence set: ``deps`` arrives as a set whose
        # iteration order depends on how it was assembled (central walk vs
        # per-home manager grants), and preds/dependents order feeds the
        # ready queues — sorting pins one schedule for both managers
        ordered = sorted(deps, key=lambda t: t.spawn_order)
        td.preds = tuple(ordered)
        for d in ordered:
            d.dependents.append(td)
        if td.deps_remaining == 0:
            td.state = TaskState.READY
            return True
        td.state = TaskState.WAITING
        self.waiting.add(td)
        return False

    # -- task execution accounting -------------------------------------------
    def mark_executed(self, td: TaskDescriptor) -> None:
        td.state = TaskState.EXECUTED
        td.exec_order = next(self._exec_counter)
        self.n_unexecuted -= 1

    # -- task release (§3.6) --------------------------------------------------
    def release(self, td: TaskDescriptor) -> list[TaskDescriptor]:
        """Decrement dependents' counters; return newly-ready tasks."""
        newly_ready = []
        for dep in td.dependents:
            dep.deps_remaining -= 1
            if dep.deps_remaining == 0 and not dep.is_complete:
                # the is_complete guard matters for staged execution,
                # where a whole wave runs before any release: an already-
                # executed dependent must not re-enter the ready queue
                # (it would pin its descriptor + outputs there forever)
                dep.state = TaskState.READY
                self.waiting.discard(dep)
                newly_ready.append(dep)
        td.dependents = []
        td.preds = ()          # keep metadata O(live tasks), as in §3.6
        self.n_unreleased -= 1
        return newly_ready

    @property
    def quiescent(self) -> bool:
        return self.n_unreleased == 0
