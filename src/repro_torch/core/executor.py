"""Executors: how a discovered task graph actually runs.

* :class:`SequentialExecutor` — serial elision; the oracle for tests.
* :class:`HostExecutor` — the paper's dynamic runtime: the spawning
  thread is the master, worker threads drain their MPB descriptor rings
  and run the task bodies (bounded slots, spawns that never block, lazy
  collection and release).
* :class:`StagedExecutor` — the DAG is layered into wavefronts and each
  wavefront's identical tile tasks are fused into one batched dispatch:
  one ``torch.func.vmap(fn)`` call, or with ``kernel_backend="pallas"``
  one launch of the hand-written wave kernel registered for the body
  (``core/wavekernel.py``).  The dependence analysis is unchanged, only
  the dispatch is batched.
"""
from __future__ import annotations

import threading
import time
from collections import OrderedDict, defaultdict
from typing import Callable, Iterable, Protocol, Sequence, runtime_checkable

import torch

from ..obs.profiler import trace_span
from ..obs.tracker import NULL_TRACKER
from . import wavekernel
from .api import suspend_runtime_scope
from .graph import TaskDescriptor, TaskGraph, TaskState, normalize_outputs
from .mpb import MPBQueue
from .scheduler import MasterScheduler

__all__ = ["Executor", "ExecutorBase", "SequentialExecutor", "HostExecutor",
           "StagedExecutor", "dependence_cone"]


@runtime_checkable
class Executor(Protocol):
    """What the runtime front-end requires of an execution strategy.

    Implementations: :class:`SequentialExecutor` (serial elision),
    :class:`HostExecutor` (the paper's dynamic master/worker protocol)
    and :class:`StagedExecutor` (wavefront batching).
    """

    def on_spawn(self, td: TaskDescriptor, ready: bool) -> None:
        """A task was initiated; ``ready`` means no unresolved deps."""
        ...

    def barrier(self) -> None:
        """Global synchronization: return once every spawned task ran."""
        ...

    def wait_for(self, tds: Sequence[TaskDescriptor]) -> None:
        """Partial synchronization: return once ``tds`` (and hence their
        dependence cones) completed — unrelated tasks need not have run."""
        ...

    def reclaim(self) -> None:
        """Make progress so a descriptor can be recycled (pool exhausted)."""
        ...

    def shutdown(self) -> None:
        ...


def dependence_cone(targets: Iterable[TaskDescriptor]) -> set[TaskDescriptor]:
    """The incomplete transitive predecessors of ``targets`` (targets
    included) — exactly what must run before a wait on them returns."""
    cone: set[TaskDescriptor] = set()
    stack = [td for td in targets if not td.is_complete]
    while stack:
        td = stack.pop()
        if td in cone:
            continue
        cone.add(td)
        stack.extend(p for p in td.preds
                     if not p.is_complete and p not in cone)
    return cone


class ExecutorBase:
    """Shared defaults for :class:`Executor` implementations.

    The runtime hands every executor the tracker it owns (``obs``), its
    traffic recorder (``traffic``) and the profiler flag (``profile``)
    right after construction; hot paths guard event construction on
    ``obs.enabled``, so the default ``NULL_TRACKER`` never builds an
    event dict.
    """

    kind = "base"                 # the ``executor`` field of emitted events
    obs = NULL_TRACKER            # set by TaskRuntime.__init__
    traffic = None                # the runtime's TileTraffic recorder
    profile = False               # RuntimeConfig.profile_waves

    def on_spawn(self, td: TaskDescriptor, ready: bool) -> None:
        raise NotImplementedError

    def barrier(self) -> None:
        raise NotImplementedError

    def wait_for(self, tds: Sequence[TaskDescriptor]) -> None:
        """Conservative default: a full barrier satisfies any wait."""
        if any(not td.is_complete for td in tds):
            self.barrier()

    def reclaim(self) -> None:
        """Make progress so a descriptor can be recycled (pool exhausted)."""
        self.barrier()

    def shutdown(self) -> None:
        pass


# ---------------------------------------------------------------------------
class SequentialExecutor(ExecutorBase):
    """Serial elision: run each task at spawn, in program order.  Program
    order is a topological order of the dependence DAG by construction, so
    every dependence is satisfied."""

    kind = "sequential"

    def __init__(self, graph: TaskGraph, scheduler: MasterScheduler):
        self.graph = graph
        self.scheduler = scheduler

    def on_spawn(self, td: TaskDescriptor, ready: bool) -> None:
        assert ready, ("sequential spawn found an unresolved dependence; "
                       "program order must satisfy all deps")
        td.state = TaskState.RUNNING
        td.run()
        self.scheduler._collect(td)
        self.scheduler.release_all()

    def barrier(self) -> None:
        assert self.graph.quiescent

    def wait_for(self, tds) -> None:
        # every task ran at its spawn; nothing can be outstanding
        assert all(td.is_complete for td in tds)


# ---------------------------------------------------------------------------
class _Worker(threading.Thread):
    """A worker core: drains its MPB ring, executes tasks, marks slots
    completed (§3.5).

    Pinned tile cache: each worker keeps up to ``cache_tiles`` assembled
    READS operands, keyed by region identity and validated by the
    *identity* of the constituent tile tensors.  Identity is exact
    freshness only because every write swaps in a new tensor
    (``BlockArray.set_tile``, ``Region.store``) and nothing on the task
    path writes a stored tile in place; the cached entry pins its tiles,
    ruling out id reuse.  A hit skips region reassembly.

    A body that raises does not end the thread: the exception is kept on
    the descriptor (``td.error``) and in ``failures``, the slot is marked
    completed, and the master re-raises it.

    On CUDA every worker launches on the device's default stream (the
    per-thread current stream, which nothing here changes), so a kernel
    queued by one worker runs after every kernel queued before it by any
    worker: a task counts as complete once its body has *queued* its
    work, and ordering on the one stream keeps its dependents correct.
    """

    def __init__(self, wid: int, queue: MPBQueue, failures: list,
                 cache_tiles: int = 0):
        super().__init__(name=f"bddt-worker-{wid}", daemon=True)
        self.wid = wid
        self.queue = queue
        self.failures = failures
        self.stop_flag = threading.Event()
        self.busy_s = 0.0
        self.tasks_run = 0
        self.cache_tiles = cache_tiles
        self.cache_hits = 0
        self.cache_misses = 0
        # region key -> (pinned tile tensors, assembled value), LRU order
        self._cache: OrderedDict = OrderedDict()

    def _materialize(self, region):
        if not self.cache_tiles:
            return region.materialize()
        key = (region.array.array_id, region.ranges)
        tiles = tuple(region.array.get_tile(i) for i in region.tile_indices)
        hit = self._cache.get(key)
        if hit is not None and len(hit[0]) == len(tiles) and \
                all(a is b for a, b in zip(hit[0], tiles)):
            self.cache_hits += 1
            self._cache.move_to_end(key)
            return hit[1]
        self.cache_misses += 1
        value = region.materialize()
        self._cache[key] = (tiles, value)
        self._cache.move_to_end(key)
        while len(self._cache) > self.cache_tiles:
            self._cache.popitem(last=False)
        return value

    def run(self) -> None:
        while not self.stop_flag.is_set():
            td = self.queue.next_ready(timeout=0.05)
            if td is None:
                continue
            td.state = TaskState.RUNNING
            t0 = time.perf_counter()
            try:
                td.run(materialize=self._materialize)
            except Exception as exc:         # handed to the master
                td.error = exc
                self.failures.append(td)
            self.busy_s += time.perf_counter() - t0
            self.tasks_run += 1
            self.queue.mark_completed(td)


class HostExecutor(ExecutorBase):
    """The paper's runtime: master = the spawning host thread, one
    :class:`_Worker` thread per MPB ring.

    The one departure from the reference: a task body that raises on a
    worker is re-raised from the master's next ``barrier``, ``wait_for``,
    ``pump`` or ``reclaim`` (the reference's worker thread would die and
    leave the master polling forever)."""

    kind = "host"

    def __init__(self, graph: TaskGraph, scheduler: MasterScheduler,
                 queues: list[MPBQueue], cache_tiles: int = 0):
        self.graph = graph
        self.scheduler = scheduler
        self.queues = queues
        self._cache_reported = False
        self.failures: list[TaskDescriptor] = []
        self.workers = [_Worker(q.worker_id, q, self.failures,
                                cache_tiles=cache_tiles)
                        for q in queues]
        for w in self.workers:
            w.start()

    def _check(self) -> None:
        """Re-raise the first exception a task body raised on a worker."""
        if self.failures:
            raise self.failures[0].error

    def _step(self) -> None:
        """One master polling step, then surface a worker's failure."""
        self.scheduler.polling_step()
        self._check()

    def on_spawn(self, td: TaskDescriptor, ready: bool) -> None:
        if ready:
            # running mode: one attempt, never block (§3.4)
            self.scheduler.schedule_running(td)
        # dependent tasks stay in the task graph until released

    def barrier(self) -> None:
        # polling mode until every spawned task has been released
        self._check()
        while not self.graph.quiescent:
            self._step()
            if not self.graph.quiescent:
                time.sleep(0)  # yield to worker threads

    def wait_for(self, tds) -> None:
        """Polling mode scoped to ``tds``: the master polls/schedules/
        releases until the waited-on tasks completed, then returns to the
        main program — in-flight unrelated tasks keep running on their
        workers undisturbed."""
        self._check()
        while not all(td.is_complete for td in tds):
            self._step()
            if not all(td.is_complete for td in tds):
                time.sleep(0)

    def pump(self) -> None:
        """One non-blocking master step: poll worker rings, release
        completed tasks, dispatch newly-ready ones.  Serving loops call
        this between arrivals so completions surface without forcing a
        dependence-cone wait."""
        self._step()

    def reclaim(self) -> None:
        # §3.3: master blocks until a task completes, freeing a descriptor
        while self.scheduler.pool.free == 0:
            self._step()
            time.sleep(0)

    def shutdown(self) -> None:
        for w in self.workers:
            w.stop_flag.set()
        for w in self.workers:
            w.join(timeout=2.0)
        if self.obs.enabled and not self._cache_reported:
            self._cache_reported = True
            for w in self.workers:
                self.obs.emit("tile_cache", worker=w.wid,
                              hits=w.cache_hits, misses=w.cache_misses)


# ---------------------------------------------------------------------------
class StagedExecutor(ExecutorBase):
    """Wavefront staging: spawn only records; the barrier layers the DAG and
    dispatches each layer as batched calls.

    Grouping: tasks in one wavefront with the same function and the same
    input/output signature are stacked on a leading task axis and run
    through one ``torch.func.vmap(fn)`` call — the analogue of handing each
    worker its MPB queue of identical tile tasks.  Firstprivate values are
    stacked as extra vmap operands, so index-parameterized tile tasks (same
    function, different offsets) share the dispatch too.  One-task groups
    call the body eagerly.
    """

    kind = "staged"

    def __init__(self, graph: TaskGraph, scheduler: MasterScheduler,
                 device: torch.device, group: bool = True,
                 kernel_backend: str = "xla"):
        self.graph = graph
        self.scheduler = scheduler
        self.device = device
        self.group = group
        self.kernel_backend = kernel_backend
        self.pending: list[TaskDescriptor] = []
        self._vmapped: dict[Callable, Callable] = {}
        self.waves_run = 0
        self.grouped_dispatches = 0
        self.kernel_dispatches = 0     # groups launched as one wave kernel
        self.kernel_fallbacks = 0      # kernel-requested groups gone vmap
        self._dispatches = 0           # all dispatch events this executor
        self._wave_id = 0              # current wave (event correlation)
        self._last_mode = "jit"        # how the last group dispatched

    def on_spawn(self, td: TaskDescriptor, ready: bool) -> None:
        self.pending.append(td)

    # -- wavefront layering ---------------------------------------------------
    def _wavefronts(self, tasks: list[TaskDescriptor]) \
            -> list[list[TaskDescriptor]]:
        indeg = {td: td.deps_remaining for td in tasks}
        frontier = [td for td, d in indeg.items() if d == 0]
        waves = []
        seen = 0
        while frontier:
            # canonical intra-wave order: spawn order, not discovery
            # order — the order is the schedule contract, so it must not
            # depend on which predecessor happened to unlock a task first
            frontier.sort(key=lambda t: t.spawn_order)
            waves.append(frontier)
            seen += len(frontier)
            nxt: list[TaskDescriptor] = []
            for td in frontier:
                for dep in td.dependents:
                    if dep in indeg:
                        indeg[dep] -= 1
                        if indeg[dep] == 0:
                            nxt.append(dep)
            frontier = nxt
        if seen != len(tasks):
            raise RuntimeError("cycle in task graph (impossible for "
                               "footprint-derived deps)")
        return waves

    def _sig(self, td: TaskDescriptor):
        """The grouping key (:func:`~.wavekernel.group_signature`): tasks
        that differ only in region contents or index values share one
        batched dispatch."""
        return wavekernel.group_signature(td)

    def _stack_group(self, group: list[TaskDescriptor]) -> list:
        """Stack each READS arg across the group, then the firstprivate
        values as ``(n,)`` operands — the canonical stacking order the
        vmap path and the wave kernels share.  ``torch.stack`` copies, so
        the stacked operands never alias a stored tile."""
        ins = []
        for pos in range(len(group[0].args)):
            if group[0].args[pos].READS:
                ins.append(torch.stack(
                    [td.args[pos].region.materialize() for td in group]))
        for pos in range(len(group[0].values)):
            dtype = wavekernel.stage_dtype(group[0].values[pos])
            ins.append(torch.stack(
                [torch.as_tensor(td.values[pos], dtype=dtype,
                                 device=self.device) for td in group]))
        return ins

    @staticmethod
    def _assign_outputs(td: TaskDescriptor, vals: tuple) -> None:
        """Commit one task's output values — the §3.5 store contract
        shared by every batched path (regions first, captured outputs
        after)."""
        for mode, value in zip(td.outputs, vals):
            mode.region.store(value)
        td.output_values = vals

    def _store_group(self, group: list[TaskDescriptor], result) -> None:
        """Unstack one batched result back into the group's regions and
        captured outputs (one slice per task, in group order)."""
        result = normalize_outputs(result, len(group[0].outputs),
                                   group[0].name or group[0].tid)
        self.grouped_dispatches += 1
        for i, td in enumerate(group):
            self._assign_outputs(
                td, tuple(stacked[i] for stacked in result))

    def _run_group(self, group: list[TaskDescriptor]) -> None:
        if self.kernel_backend == "pallas":
            reason = self._try_wave_kernel(group)
            if reason is None:
                return                 # wave kernel launched
            self._note_kernel_fallback(group, reason)
        fn = group[0].fn
        if len(group) == 1 or not self.group:
            for td in group:
                _run_one(td)
            return
        for td in group:
            td.state = TaskState.RUNNING
        ins = self._stack_group(group)
        vfn = self._vmapped.get(fn)
        if vfn is None:
            vfn = self._vmapped[fn] = torch.func.vmap(fn)
        self._last_mode = "vmap"
        with suspend_runtime_scope():    # vmap runs fn on this thread
            result = vfn(*ins)
        self._store_group(group, result)

    # -- the wave-kernel backend (kernel_backend="pallas") --------------------
    def _try_wave_kernel(self, group: list[TaskDescriptor]) -> str | None:
        """Launch the group as one registered wave kernel if it qualifies.
        Returns None on success (results committed), else the fallback
        reason — the caller then takes the vmap path.  A kernel that
        fails to build or launch raises: only ineligible or unregistered
        groups fall back."""
        if not self.group:
            return "ungrouped"
        reason = wavekernel.eligibility(group)
        if reason is not None:
            return reason
        td = group[0]
        kernel = wavekernel.wave_kernel_for(td.fn)
        if kernel is None:
            return "no_kernel"
        label = td.name or td.fn.__name__
        for t in group:
            t.state = TaskState.RUNNING
        ins = self._stack_group(group)
        out_shapes = tuple(m.region.shape for m in td.outputs)
        result = kernel(*ins, out_shapes=out_shapes)
        for value, shape in zip(
                normalize_outputs(result, len(td.outputs), label),
                out_shapes):
            if tuple(value.shape) != (len(group), *shape):
                raise RuntimeError(
                    f"wave kernel for {label} returned shape "
                    f"{tuple(value.shape)}, expected "
                    f"{(len(group), *shape)}")
        self._last_mode = "pallas"
        self.kernel_dispatches += 1
        if self.obs.enabled:
            self.obs.emit("kernel_dispatch", wave=self._wave_id,
                          executor=self.kind, fn=label, tasks=len(group),
                          backend="pallas", reason="")
        self._store_group(group, result)
        return None

    def _note_kernel_fallback(self, group: list[TaskDescriptor],
                              reason: str) -> None:
        """Account one kernel-requested group that takes the vmap path."""
        self.kernel_fallbacks += 1
        if self.obs.enabled:
            td = group[0]
            self.obs.emit("kernel_dispatch", wave=self._wave_id,
                          executor=self.kind,
                          fn=td.name or td.fn.__name__, tasks=len(group),
                          backend="xla", reason=reason)

    # -- wave instrumentation -------------------------------------------------
    def _traffic_snapshot(self) -> tuple[int, int, int]:
        t = self.traffic
        if t is None:
            return (0, 0, 0)
        return (t.tile_moves, t.bytes_moved, t.bytes_staged)

    def _run_wave_group(self, group: list[TaskDescriptor]) -> None:
        if not self.obs.enabled:
            self._run_group(group)
            return
        # dequeue before dispatch so live depth means "queued, not yet
        # dispatched"
        self.obs.queue(0, -len(group))
        self._last_mode = "jit"
        t0 = time.perf_counter()
        self._run_group(group)
        wall = time.perf_counter() - t0
        self._dispatches += 1
        td = group[0]
        self.obs.emit("dispatch", wave=self._wave_id, executor=self.kind,
                      fn=td.name or td.fn.__name__, tasks=len(group),
                      mode=self._last_mode, wall_s=wall)

    def _run_waves(self, tasks: list[TaskDescriptor]) -> None:
        for wave in self._wavefronts(tasks):
            self.waves_run += 1
            groups: dict = defaultdict(list)
            for td in wave:
                groups[self._sig(td)].append(td)
            if self.obs.enabled:
                self._wave_id += 1
                wid = self._wave_id
                self.obs.emit("wave_open", wave=wid, executor=self.kind,
                              tasks=len(wave), groups=len(groups))
                # the staged path has one logical dispatch channel (0)
                self.obs.queue(0, len(wave))
                moves0, moved0, staged0 = self._traffic_snapshot()
                disp0 = self._dispatches
                t0 = time.perf_counter()
                with trace_span(f"bddt/{self.kind}/wave{wid}", self.profile):
                    for group in groups.values():
                        self._run_wave_group(group)
                wall = time.perf_counter() - t0
                moves1, moved1, staged1 = self._traffic_snapshot()
                self.obs.emit("wave_close", wave=wid, executor=self.kind,
                              tasks=len(wave), wall_s=wall,
                              dispatches=self._dispatches - disp0,
                              tile_moves=moves1 - moves0,
                              bytes_moved=moved1 - moved0,
                              bytes_staged=staged1 - staged0)
            else:
                for group in groups.values():
                    self._run_group(group)
            for td in wave:
                self.scheduler._collect(td)
        self.scheduler.release_all()

    def barrier(self) -> None:
        self._run_waves(self.pending)
        self.pending.clear()

    def wait_for(self, tds) -> None:
        """Stage and dispatch *only* the dependence cone of ``tds``; every
        pending task outside the cone stays pending for a later wave."""
        cone = dependence_cone(tds)
        if not cone:
            return
        self._run_waves([td for td in self.pending if td in cone])
        self.pending = [td for td in self.pending if td not in cone]

    def reclaim(self) -> None:
        self.barrier()


def _run_one(td: TaskDescriptor) -> None:
    """Run one task eagerly on the master thread."""
    td.state = TaskState.RUNNING
    td.run()
