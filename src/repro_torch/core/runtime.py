"""The BDDT-SCC front-end: declarative tasks, futures, region-scoped waits.

The programming model — declare each kernel's footprint once with
:func:`~repro_torch.core.api.task`, then call it naturally inside a
runtime scope::

    from repro_torch.core import RuntimeConfig, TaskRuntime, task

    @task(inout="c", in_=("a", "b"), firstprivate="alpha")
    def gemm(c, a, b, alpha=1.0):
        return c + alpha * (a @ b)

    with TaskRuntime(RuntimeConfig(executor="host", n_workers=4)) as rt:
        A = rt.from_array(a, block_shape=(64, 64))
        B = rt.from_array(b, block_shape=(64, 64))
        C = rt.zeros((n, n), block_shape=(64, 64))
        for i in range(g):
            for j in range(g):
                for k in range(g):
                    f = gemm(C[i, j], A[i, k], B[k, j], 0.5)  # TaskFuture
        rt.wait_on(C[0, 0])      # taskwait on a region: forces only the
        ...                      # tasks (and deps) touching that block
        rt.barrier()             # global sync (also implied at scope exit)
    result = C.gather()

Synchronization surface:

* ``future.result()`` / ``future.wait()`` — force one task's dependence
  cone only;
* ``rt.wait_on(region, mode=...)`` — wait for the live tasks whose
  footprints conflict with ``region`` under ``mode``;
* ``rt.barrier()`` — full quiescence.

Task functions receive one tensor per READS argument (in argument
order), then their firstprivate values (in parameter order), and return
one tensor per WRITES argument (in argument order).
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Sequence

import torch

from .api import (ExecutorKind, RuntimeConfig, RuntimeStats, TaskFuture,
                  _pop_runtime, _push_runtime)
from .blocks import (AccessMode, BlockArray, Region, TileTraffic,
                     coerce_mode, resolve_device)
from .deps import DependenceAnalyzer
from .executor import (Executor, HostExecutor, SequentialExecutor,
                       StagedExecutor)
from .graph import DescriptorPool, TaskDescriptor, TaskGraph
from .mpb import MPBQueue
from .placement import assign_homes
from .scheduler import MasterScheduler

__all__ = ["TaskRuntime"]


class TaskRuntime:
    """One master + N workers + the block store, wired per the paper."""

    def __init__(self, config: RuntimeConfig | None = None, **overrides):
        if config is None:
            config = RuntimeConfig(**overrides)
        elif overrides:
            config = config.replace(**overrides)
        # validate() also normalizes typed choice members (ExecutorKind
        # etc.) to canonical strings — internals only see those
        self.config = config = config.validate()
        if torch.device(config.device).type == "cuda" and \
                not torch.cuda.is_available():
            raise RuntimeError(
                f"device={config.device!r} but CUDA is not available; pass "
                "device='cpu' to run the plain PyTorch versions on the CPU")
        self.device = resolve_device(config.device)
        self.executor_kind = config.executor
        self.placement = config.placement
        self.n_controllers = config.n_controllers
        self.graph = TaskGraph()
        self.pool = DescriptorPool(config.pool_capacity)
        if config.dep_manager == "sharded":
            from .depman import ShardedDependenceManager
            # "auto" resolves here, at construction: threaded iff
            # REPRO_DEPMAN_THREADS parses as a positive integer (which
            # also caps the pump-thread count); explicit "sync" /
            # "threaded" are always honored regardless of environment
            pump = config.dep_pump
            if pump == "auto":
                try:
                    n_threads = int(os.environ.get(
                        "REPRO_DEPMAN_THREADS", "0"))
                except ValueError:
                    n_threads = 0
                pump = "threaded" if n_threads > 0 else "sync"
            self.dep_pump = pump
            self.analyzer = ShardedDependenceManager(
                n_managers=config.n_controllers,
                channel_slots=config.mpb_slots,
                batch_lines=config.dep_batch_lines,
                pump=pump)
        else:
            self.dep_pump = None
            self.analyzer = DependenceAnalyzer()
        self.queues = [MPBQueue(w, config.mpb_slots)
                       for w in range(config.n_workers)]
        self.scheduler = MasterScheduler(self.queues, self.graph, self.pool,
                                         self.analyzer, policy=config.policy,
                                         seed=config.seed)
        # measured tile movement (shared by every array this runtime
        # registers; the memory layer charges it, stats() reports it)
        self.traffic = TileTraffic()
        # observability: one tracker per runtime, handed to the scheduler
        # and the executor.  ``owned`` sinks (built from a spec string)
        # are closed at shutdown; caller-provided instances stay open.
        from ..obs.tracker import make_tracker
        self.obs, self._obs_owned = make_tracker(config.tracker)
        self._closed = False
        self.scheduler.obs = self.obs
        if hasattr(self.analyzer, "register_array"):
            # sharded dependence manager: emits dep_msg/manager_admit
            # events through the runtime's tracker like everything else
            self.analyzer.obs = self.obs
        self._exec: Executor = self._make_executor(config)
        self._exec.obs = self.obs
        self._exec.traffic = self.traffic
        self._exec.profile = config.profile_waves
        self._arrays: list[BlockArray] = []
        # ``repro_torch.serve`` attaches its AdmissionController here so
        # ``stats()`` surfaces the admission_* fields; None when the
        # runtime is not serving
        self.admission = None
        self._spawn_counter = 0
        self.spawn_time_s = 0.0
        self.barrier_time_s = 0.0
        self.wait_time_s = 0.0
        self.region_waits = 0
        self.futures_resolved = 0

    def _make_executor(self, config: RuntimeConfig) -> Executor:
        if config.executor == ExecutorKind.SEQUENTIAL:
            return SequentialExecutor(self.graph, self.scheduler)
        if config.executor == ExecutorKind.HOST:
            return HostExecutor(self.graph, self.scheduler, self.queues,
                                cache_tiles=config.worker_cache_tiles)
        if config.executor == ExecutorKind.SIM:
            from .sim import SimExecutor
            return SimExecutor(self.graph, self.scheduler,
                               n_workers=config.n_workers,
                               mpb_slots=config.mpb_slots,
                               cost_fn=config.sim_cost_fn,
                               params=config.sim_params,
                               dep_managers=(config.n_controllers
                                             if config.dep_manager ==
                                             "sharded" else None),
                               dep_batch_lines=config.dep_batch_lines,
                               kernel_backend=config.kernel_backend)
        if config.executor == ExecutorKind.SHARDED:
            from .sharded import ShardedExecutor
            return ShardedExecutor(
                self.graph, self.scheduler, self.device,
                group=config.group_waves, n_homes=config.n_controllers,
                owner_skew_threshold=config.owner_skew_threshold,
                kernel_backend=config.kernel_backend)
        return StagedExecutor(self.graph, self.scheduler, self.device,
                              group=config.group_waves,
                              kernel_backend=config.kernel_backend)

    # -- memory management (§3.2): the custom allocator --------------------------
    def register(self, ba: BlockArray) -> BlockArray:
        """Adopt ``ba`` (built here or by ``repro_torch.interop``): assign
        block homes, attach the runtime's traffic recorder, and — if the
        executor wants residency (sharded under a mesh) — swap in the
        store that places each tile on its home device.  Its tiles must
        already live on this runtime's device; after this, ``from_array``/
        ``zeros``/``full`` results live where
        ``placement.device_assignment`` says they do."""
        if ba.device != self.device:
            raise ValueError(f"{ba.name} lives on {ba.device}, the runtime "
                             f"on {self.device}")
        assign_homes(ba, self.placement, self.n_controllers)
        ba.traffic = self.traffic
        register = getattr(self.analyzer, "register_array", None)
        if register is not None:
            # sharded dependence manager learns the block -> home map so
            # footprints route to the owning per-home manager
            register(ba)
        make_store = getattr(self._exec, "make_store", None)
        if make_store is not None:
            store = make_store(ba)
            if store is not None:
                ba.use_store(store)
        self._arrays.append(ba)
        return ba

    def from_array(self, arr, block_shape: Sequence[int],
                   name: str | None = None) -> BlockArray:
        return self.register(BlockArray.from_array(
            arr, block_shape, name, device=self.device))

    def zeros(self, shape, block_shape, dtype=None,
              name: str | None = None) -> BlockArray:
        return self.register(BlockArray.zeros(
            shape, block_shape, dtype or torch.float32, name,
            device=self.device))

    def full(self, shape, block_shape, fill, dtype=None,
             name: str | None = None) -> BlockArray:
        return self.register(BlockArray.full(
            shape, block_shape, fill, dtype or torch.float32, name,
            device=self.device))

    # -- task initiation (§3.3) -----------------------------------------------------
    def _initiate(self, fn: Callable, args: Sequence[AccessMode],
                  name: str = "", values: tuple = ()) -> TaskFuture:
        """The task-initiation path of every ``@task`` spawn site: acquire
        a descriptor (blocking on pool exhaustion), discover dependencies,
        hand to the executor.  ``values`` carries the firstprivate
        by-value parameters."""
        t0 = time.perf_counter()
        td = self.pool.acquire(fn, args, name=name, values=values)
        while td is None:
            # §3.3: no free descriptors -> master blocks until one recycles
            self._exec.reclaim()
            td = self.pool.acquire(fn, args, name=name, values=values)
        td.spawn_order = self._spawn_counter
        self._spawn_counter += 1
        deps = self.analyzer.analyze(td)
        ready = self.graph.insert(td, deps)
        self._exec.on_spawn(td, ready)
        self.spawn_time_s += time.perf_counter() - t0
        return TaskFuture(self, td)

    # -- synchronization ---------------------------------------------------------------
    def _wait_tasks(self, tds: Sequence[TaskDescriptor],
                    kind: str = "future") -> None:
        t0 = time.perf_counter()
        self._exec.wait_for(tds)
        self.wait_time_s += time.perf_counter() - t0
        if kind == "future":
            self.futures_resolved += len(tds)

    def wait_on(self, *regions, mode="in") -> None:
        """Region-scoped taskwait (OmpSs ``taskwait on(...)``).

        Returns once every live task whose footprint conflicts with
        ``regions`` under ``mode`` has completed — in-flight tasks with
        disjoint footprints are *not* waited for.  ``"in"`` waits for
        pending writers; ``"out"``/``"inout"`` also for pending readers."""
        mode = coerce_mode(mode)
        blocks = []
        for r in regions:
            if isinstance(r, BlockArray):
                r = r.whole
            if isinstance(r, AccessMode):
                raise TypeError("wait_on takes regions, not In/Out/InOut "
                                "wrappers; pass e.g. A[i, j]")
            if not isinstance(r, Region):
                raise TypeError(f"wait_on expected a Region or BlockArray, "
                                f"got {type(r).__name__}")
            blocks.extend(r.block_ids)
        targets = self.analyzer.tasks_touching(blocks, mode=mode)
        self.region_waits += 1
        if targets:
            self._wait_tasks(sorted(targets, key=lambda t: t.spawn_order),
                             kind="region")

    def wait_all(self, futures: Sequence[TaskFuture]) -> list:
        """Wait on several futures at once; returns their results."""
        self._wait_tasks([f.descriptor for f in futures], kind="future")
        return [f.result() for f in futures]

    def barrier(self) -> None:
        t0 = time.perf_counter()
        self._exec.barrier()
        quiesce = getattr(self.analyzer, "quiesce", None)
        if quiesce is not None:
            # sharded manager: flush buffered release descriptors and
            # wait out the pump threads so metadata and the batch/line
            # counters are exact at the barrier
            quiesce()
        self.barrier_time_s += time.perf_counter() - t0
        assert self.graph.quiescent

    def shutdown(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._exec.shutdown()
        stop_analyzer = getattr(self.analyzer, "shutdown", None)
        if stop_analyzer is not None:
            # quiesces and joins the dependence pump threads, so the
            # stats emitted below carry final counter values
            stop_analyzer()
        if self.obs.enabled:
            # the final stats snapshot, in the same schema to_json() emits
            self.obs.emit("stats", stats=self.stats().to_dict())
        if self._obs_owned:
            self.obs.close()

    # -- the runtime scope --------------------------------------------------------------
    @contextlib.contextmanager
    def scope(self):
        """Activate as the ambient runtime for ``@task`` calls *without*
        taking ownership: no barrier or shutdown at exit.  Use ``with
        rt:`` for the owning form (callers that create the runtime)."""
        _push_runtime(self)
        try:
            yield self
        finally:
            _pop_runtime(self)

    def __enter__(self) -> "TaskRuntime":
        _push_runtime(self)
        return self

    def __exit__(self, *exc) -> None:
        _pop_runtime(self)
        try:
            if exc == (None, None, None):
                self.barrier()
        finally:
            self.shutdown()

    # -- instrumentation -----------------------------------------------------------------
    def stats(self) -> RuntimeStats:
        s = RuntimeStats(
            tasks_spawned=self._spawn_counter,
            tasks_scheduled=self.scheduler.tasks_scheduled,
            polling_rounds=self.scheduler.polling_rounds,
            blocks_walked=self.analyzer.blocks_walked,
            deps_found=self.analyzer.deps_found,
            spawn_time_s=self.spawn_time_s,
            barrier_time_s=self.barrier_time_s,
            wait_time_s=self.wait_time_s,
            region_waits=self.region_waits,
            futures_resolved=self.futures_resolved,
            mpb_full_rejections=sum(q.full_rejections for q in self.queues),
        )
        if isinstance(self._exec, HostExecutor):
            s.worker_busy_s = [w.busy_s for w in self._exec.workers]
            s.worker_tasks = [w.tasks_run for w in self._exec.workers]
            s.worker_cache_hits = [w.cache_hits for w in self._exec.workers]
            s.worker_cache_misses = [w.cache_misses
                                     for w in self._exec.workers]
        if isinstance(self._exec, StagedExecutor):
            s.waves = self._exec.waves_run
            s.grouped_dispatches = self._exec.grouped_dispatches
        # wave-kernel counters, duck-typed so the staged executor (real)
        # and the sim executor (predicted) report the same fields; inert
        # under "xla"
        if getattr(self._exec, "kernel_backend", "xla") == "pallas":
            s.kernel_dispatches = self._exec.kernel_dispatches
            s.kernel_fallbacks = self._exec.kernel_fallbacks
        # residency semantics are shared by every executor: the measured
        # movement comes from the memory layer's recorder (zero under
        # executors that never place tiles on devices)
        s.tile_moves = self.traffic.tile_moves
        s.bytes_moved = self.traffic.bytes_moved
        s.bytes_staged = self.traffic.bytes_staged
        # duck-typed so the single-device path never imports the sharded
        # module just to fill in stats
        if getattr(self._exec, "cross_home_bytes", None) is not None:
            s.sharded_dispatches = self._exec.sharded_dispatches
            s.cross_home_bytes = self._exec.cross_home_bytes
            s.local_home_bytes = self._exec.local_home_bytes
            s.owner_overrides = self._exec.owner_overrides
        # sharded dependence manager: message traffic + per-manager
        # admissions (None under the central analyzer)
        if getattr(self.analyzer, "dep_messages", None) is not None:
            s.dep_messages = self.analyzer.dep_messages
            s.dep_batches = self.analyzer.dep_batches
            s.dep_lines = self.analyzer.dep_lines
            s.pump_wall_s = self.analyzer.pump_wall_s
            s.manager_admissions = list(self.analyzer.admissions)
        # serving admission controller (attached by repro_torch.serve)
        if self.admission is not None:
            a = self.admission
            s.admission_submitted = a.submitted
            s.admission_admitted = a.admitted
            s.admission_rejected = a.rejected
            s.admission_deferred = a.deferred
            s.admission_peak_bytes = a.peak_in_flight_bytes
            s.admission_budget_bytes = a.budget_bytes
        if getattr(self._exec, "last_result", None) is not None:
            s.predicted_total_s = self._exec.predicted_total_s
            # the DES never executes bodies: tile_moves is its *predicted*
            # count of cross-home block fetches
            s.tile_moves = self._exec.predicted_tile_moves
        return s
