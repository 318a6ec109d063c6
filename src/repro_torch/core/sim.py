"""Discrete-event simulation of the BDDT-SCC runtime on the SCC (the JAX
package's ``core/sim.py``).

Replays the exact runtime protocol of §3.3-§3.6 — master spawns with
dependence-analysis cost, running-mode single-attempt scheduling into
bounded MPB rings, polling mode at barriers, lazy collection and release —
against the calibrated hardware model of ``costmodel.py`` (hop-dependent
DRAM latency, per-MC contention, whole-L2 flush/invalidate).  Workloads are
task graphs annotated with per-task flops / bytes / block homes.

:class:`SimTask`, :class:`SimResult`, :func:`simulate`,
:func:`sequential_time` and :func:`predict_dep_traffic` are the
reference's, in pure Python, and give the reference's numbers on the same
task lists.  What differs is where a task's cost comes from
(:class:`FlopcountCost` counts the aten ops of the body run on ``meta``
tensors, ``launch/flopcount.py``) and which groups the wave-kernel
prediction fuses (:meth:`SimExecutor._predict_fused` asks the port's own
registry, as the port's staged executor does).
"""
from __future__ import annotations

import heapq
from collections import Counter, defaultdict
from dataclasses import dataclass, field

import numpy as np
import torch

from ..launch.flopcount import count_step
from . import wavekernel
from .costmodel import (SCCParams, core_core_hops, core_mc_hops,
                        master_core_choice, worker_order)
from .depman import grant_slots
from .executor import ExecutorBase
from .mpb import DESCRIPTORS_PER_LINE, lines_for

__all__ = ["SimTask", "SimResult", "SimExecutor", "FlopcountCost",
           "simulate", "sequential_time", "predict_dep_traffic"]


@dataclass
class SimTask:
    """One task of a workload graph."""
    tid: int
    flops: float
    mem_bytes: float
    homes: tuple[int, ...]            # MCs serving this task's blocks
    deps: tuple[int, ...] = ()        # tids this task waits for
    n_blocks: int = 1                 # footprint size (dep-analysis cost)
    # actual footprint bytes behind each MC in ``homes`` (same order).
    # None = split ``mem_bytes`` evenly (the synthetic-workload default);
    # SimExecutor fills it from real task footprints so the contention
    # model charges each controller for the bytes it really serves — the
    # residency semantics the executors measure, consumed by the DES.
    home_bytes: tuple[float, ...] | None = None
    # footprint blocks behind each home in ``homes`` (same order).  None =
    # split ``n_blocks`` evenly.  Under sharded dependence management the
    # per-home managers walk their slices in parallel, so the spawn charge
    # is the *max* per-manager walk, not the sum — this carries the split.
    home_blocks: tuple[int, ...] | None = None
    # kernel_backend="pallas": this task runs inside a fused wave kernel.
    # ``onchip_bytes`` is the slice of ``mem_bytes`` the fused grid keeps
    # in on-chip memory (the write-back footprint staged MPB-style between
    # grid steps): the DES charges it at MPB line cost instead of
    # contended DRAM, and skips the per-task whole-L2 flush — one wave,
    # one kernel, one flush (amortized to ~0 per task, §3.2).
    fused: bool = False
    onchip_bytes: float = 0.0

    # simulation state (reset per run)
    deps_remaining: int = 0
    dependents: list = field(default_factory=list)


@dataclass
class WorkerState:
    core: int
    mc_hops: list[int]
    queue: list = field(default_factory=list)   # FIFO of queued tasks
    running: object = None
    free_at: float = 0.0
    busy_s: float = 0.0
    flush_s: float = 0.0
    tasks_run: int = 0
    inflight: int = 0


@dataclass
class SimResult:
    total_s: float
    worker_busy_s: list[float]
    worker_flush_s: list[float]
    worker_idle_s: list[float]
    worker_tasks: list[int]
    master_busy_s: float
    tasks: int

    @property
    def breakdown(self) -> dict:
        return {
            "app_s": sum(self.worker_busy_s),
            "flush_s": sum(self.worker_flush_s),
            "idle_s": sum(self.worker_idle_s),
        }


class FlopcountCost:
    """The default ``sim_cost_fn``: flop/byte accounting of the task
    *body* (``launch/flopcount.py``) combined with the descriptor's
    declared footprint.

    The body runs once per (function, input-structure) pair on ``meta``
    tensors shaped like its READS regions, its firstprivate values as
    ``meta`` tensors of the shape and dtype the staged executor stages
    them in (``wavekernel.stage_dtype``; a scalar is 0-d).  Nothing is
    computed and nothing launches; the walk counts every aten op the body
    runs, and an operator of this package through its plain version.
    DRAM bytes are the larger of

    * the walk's byte estimate (inputs and outputs of every op that is not
      a layout change), and
    * the footprint traffic a non-coherent SCC core cannot avoid: every
      READS region fetched from DRAM plus every WRITES region flushed back
      (an ``inout`` region counts for both).

    Results are cached on input *structure* (the wave-grouping key,
    ``wavekernel.group_signature``: shapes and dtypes, never values).
    A body that cannot run on ``meta`` tensors (value-dependent Python
    control flow, an op with no meta implementation) falls back to the
    footprint-derived estimate of :meth:`SimExecutor._footprint_cost`,
    remembered as ``None`` in the cache.
    """

    def __init__(self):
        self._cache: dict[tuple, tuple[float, float] | None] = {}

    @staticmethod
    def _meta_args(td) -> list[torch.Tensor]:
        args = [torch.empty(m.region.shape, dtype=m.region.array.dtype,
                            device="meta")
                for m in td.args if m.READS]
        for v in td.values:
            shape = tuple(v.shape) if isinstance(v, torch.Tensor) \
                else np.shape(v)
            args.append(torch.empty(shape, dtype=wavekernel.stage_dtype(v),
                                    device="meta"))
        return args

    def _key(self, td) -> tuple:
        return wavekernel.group_signature(td)

    def __call__(self, td) -> tuple[float, float]:
        key = self._key(td)
        counted = self._cache.get(key, False)
        if counted is False:
            try:
                c = count_step(td.fn, *self._meta_args(td))
                counted = (float(c["flops"]), float(c["bytes"]))
            except Exception:
                counted = None           # not runnable on meta tensors
            self._cache[key] = counted
        if counted is None:
            return SimExecutor._footprint_cost(td)
        flops, walk_bytes = counted
        read_b = sum(m.region.nbytes for m in td.args if m.READS)
        write_b = sum(m.region.nbytes for m in td.args if m.WRITES)
        return flops, max(walk_bytes, float(read_b + write_b))


class SimExecutor(ExecutorBase):
    """The DES behind the :class:`~repro_torch.core.executor.Executor`
    protocol.

    ``TaskRuntime(executor="sim")`` runs a *real task program* —
    footprints, dependence analysis, descriptor pool and all — but
    instead of executing task bodies, the barrier replays the accumulated
    DAG through :func:`simulate` on the calibrated SCC cost model.  Task
    outputs are **not** computed and no kernel launches (timing-only);
    the predicted makespan lands in ``RuntimeStats.predicted_total_s``
    and the full :class:`SimResult` in :attr:`last_result`.

    Per-task costs default to :class:`FlopcountCost`; pass
    ``sim_cost_fn`` in RuntimeConfig to override, or ``sim_params`` to run
    on calibrated :class:`~repro_torch.core.costmodel.SCCParams`.
    """

    kind = "sim"

    def __init__(self, graph, scheduler, *, n_workers: int = 4,
                 mpb_slots: int = 16, cost_fn=None,
                 params: SCCParams | None = None,
                 dep_managers: int | None = None,
                 dep_batch_lines: int = 1,
                 kernel_backend: str = "xla"):
        self.graph = graph
        self.scheduler = scheduler
        self.n_workers = n_workers
        self.mpb_slots = mpb_slots
        self.cost_fn = cost_fn or FlopcountCost()
        self.params = params or SCCParams()
        # RuntimeConfig.dep_manager="sharded": charge spawns as manager
        # message traffic + parallel per-home walks instead of one
        # master-side walk (None = the central §3.3 cost); batch_lines>1
        # amortizes the per-descriptor line charge (line packing)
        self.dep_managers = dep_managers
        self.dep_batch_lines = dep_batch_lines
        # RuntimeConfig.kernel_backend="pallas": predict which groups the
        # staged executor would launch as wave kernels and charge their
        # write-back traffic at on-chip rather than DRAM cost.  Counters
        # mirror the staged executor's RuntimeStats fields, here as
        # predictions; ``fallbacks`` counts the fallback groups by reason.
        self.kernel_backend = kernel_backend
        self.kernel_dispatches = 0
        self.kernel_fallbacks = 0
        self.fallbacks: Counter = Counter()
        self.pending = []
        self.last_result: SimResult | None = None
        # fragments compose sequentially (each sync point serializes the
        # master), so the program's predicted makespan is their sum
        self.predicted_total_s = 0.0
        # residency prediction: cross-home block fetches the footprints
        # imply under owner-computes (the DES never stages data — 32-byte
        # descriptors move through the MPBs, blocks stay at their homes)
        self.predicted_tile_moves = 0

    @staticmethod
    def _footprint_cost(td) -> tuple[float, float]:
        """Footprint-only estimate: bytes = the whole footprint, flops =
        2 x elements touched (a BLAS-1-ish density).  This is the
        fallback :class:`FlopcountCost` uses for bodies that cannot run on
        ``meta`` tensors.  A custom cost_fn receives the full descriptor
        — including ``td.values``, the firstprivate parameters — so
        per-task costs can depend on index values (e.g. trailing-submatrix
        size in a factorization)."""
        total_bytes = sum(m.region.nbytes for m in td.args)
        elems = sum(int(np.prod(m.region.shape)) for m in td.args)
        return 2.0 * elems, float(total_bytes)

    def _predict_fused(self) -> set[int]:
        """Replay the staged executor's wavefront layering + grouping over
        the pending batch and decide each group as the port's staged
        executor does (``StagedExecutor._try_wave_kernel``): the shared
        eligibility (``wavekernel.eligibility``), then the registry
        (``wavekernel.wave_kernel_for``; a body with no kernel falls back
        as ``"no_kernel"``).  The prediction is therefore what the staged
        executor launches.  The reference fuses every eligible group, so
        its ``kernel_dispatches`` equal the port's plus the port's
        ``no_kernel`` fallbacks."""
        fused: set[int] = set()
        indeg = {td: td.deps_remaining for td in self.pending}
        frontier = [td for td in self.pending if indeg[td] == 0]
        while frontier:
            frontier.sort(key=lambda t: t.spawn_order)
            groups = defaultdict(list)
            for td in frontier:
                groups[wavekernel.group_signature(td)].append(td)
            for g in groups.values():
                reason = wavekernel.eligibility(g)
                if reason is None and \
                        wavekernel.wave_kernel_for(g[0].fn) is None:
                    reason = "no_kernel"
                if reason is None:
                    self.kernel_dispatches += 1
                    fused.update(t.tid for t in g)
                else:
                    self.kernel_fallbacks += 1
                    self.fallbacks[reason] += 1
            nxt = []
            for td in frontier:
                for dep in td.dependents:
                    if dep in indeg:
                        indeg[dep] -= 1
                        if indeg[dep] == 0:
                            nxt.append(dep)
            frontier = nxt
        return fused

    def _to_sim(self, td, batch_tids: set[int],
                fused_tids: set[int] = frozenset()) -> SimTask:
        flops, mem = self.cost_fn(td)
        owner = 0
        for m in td.args:
            if m.WRITES:
                owner = m.region.array.home.get(m.region.tile_indices[0], 0)
                break
        per_home: dict[int, float] = {}
        per_home_blocks: dict[int, int] = {}
        n_blocks = 0
        for m in td.args:
            n_blocks += len(m.region.block_ids)
            block_bytes = m.region.nbytes / max(len(m.region.tile_indices), 1)
            for idx in m.region.tile_indices:
                h = m.region.array.home.get(idx, 0)
                per_home[h] = per_home.get(h, 0.0) + block_bytes
                per_home_blocks[h] = per_home_blocks.get(h, 0) + 1
                if m.READS and h != owner:
                    self.predicted_tile_moves += 1
        homes = tuple(sorted(per_home)) or (0,)
        fused = td.tid in fused_tids
        # the fused grid stages the write-back footprint on-chip: outputs
        # stream between grid steps instead of flushing to DRAM per task
        onchip = (float(sum(m.region.nbytes for m in td.args if m.WRITES))
                  if fused else 0.0)
        return SimTask(
            tid=td.tid, flops=float(flops), mem_bytes=float(mem),
            homes=homes,
            deps=tuple(p.tid for p in td.preds if p.tid in batch_tids),
            n_blocks=max(n_blocks, 1),
            home_bytes=tuple(per_home.get(h, 0.0) for h in homes) or None,
            home_blocks=tuple(per_home_blocks.get(h, 0)
                              for h in homes) or None,
            fused=fused, onchip_bytes=min(onchip, float(mem)))

    def on_spawn(self, td, ready: bool) -> None:
        self.pending.append(td)

    def barrier(self) -> None:
        if not self.pending:
            return
        batch_tids = {td.tid for td in self.pending}
        fused_tids = (self._predict_fused()
                      if self.kernel_backend == "pallas" else frozenset())
        sim_tasks = [self._to_sim(td, batch_tids, fused_tids)
                     for td in self.pending]
        self.last_result = simulate(sim_tasks, self.n_workers, self.params,
                                    mpb_slots=self.mpb_slots,
                                    dep_managers=self.dep_managers,
                                    dep_batch_lines=self.dep_batch_lines)
        self.predicted_total_s += self.last_result.total_s
        if self.obs.enabled:
            # predicted (parallel DES makespan) vs configured cost (the
            # same tasks serial on the master, no contention/flushes) —
            # the §6 speedup the tracker records per fragment
            self.obs.emit("sim_predict", tasks=len(sim_tasks),
                          predicted_s=self.last_result.total_s,
                          sequential_s=sequential_time(sim_tasks,
                                                       self.params))
        for td in self.pending:
            self.scheduler._collect(td)
        self.scheduler.release_all()
        self.pending.clear()


def sequential_time(tasks: list[SimTask], p: SCCParams,
                    master: int | None = None) -> float:
    """The paper's baseline: the original program on the master core, all
    memory served by the nearest controller, no contention, no flushes."""
    master = master if master is not None else master_core_choice()
    near = min(range(4), key=lambda m: core_mc_hops(master, m))
    h = core_mc_hops(master, near)
    t = 0.0
    for task in tasks:
        t += p.compute_time_s(task.flops)
        t += p.mem_time_s(task.mem_bytes, h, concurrent=1)
    return t


def simulate(tasks: list[SimTask], n_workers: int,
             p: SCCParams = SCCParams(), *, mpb_slots: int = 16,
             placement_aware: bool = True,
             dep_managers: int | None = None,
             dep_batch_lines: int = 1) -> SimResult:
    """Run the master/worker protocol over the task graph.

    ``dep_managers`` switches the spawn/release charges to sharded
    dependence management: N per-home managers (manager ``m`` sits at MC
    ``m % 4``), each walking its slice of the footprint concurrently.  A
    spawn then costs the base initiation plus one dep_query/dep_grant
    round-trip per involved manager plus the *max* per-manager metadata
    walk (they overlap — the distributed-manager win); a release adds one
    message per involved manager.  ``None`` is the paper's central §3.3
    walk on the master.

    ``dep_batch_lines`` mirrors ``RuntimeConfig.dep_batch_lines``: at 1
    every descriptor crosses the mesh in its own 32-byte MPB line (the
    pre-batching wire behavior, one ``mpb_write_s`` per message); above 1
    the master packs ``DESCRIPTORS_PER_LINE`` descriptors per line, so
    the steady-state per-descriptor charge amortizes to
    ``1/DESCRIPTORS_PER_LINE`` of a line write — the same line-packing
    the measured runtime reports as ``dep_lines < dep_messages``.
    """
    master = master_core_choice()
    cores = worker_order(master)[:n_workers]
    workers = [WorkerState(core=c,
                           mc_hops=[core_mc_hops(c, m) for m in range(4)])
               for c in cores]
    mpb_hops = [core_core_hops(master, c) for c in cores]

    # reset graph state
    by_id = {t.tid: t for t in tasks}
    for t in tasks:
        t.deps_remaining = len(t.deps)
        t.dependents = []
    for t in tasks:
        for d in t.deps:
            by_id[d].dependents.append(t)

    # per-MC load: sum of memory-boundedness fractions of active tasks
    # (a compute-bound task barely contends; Fig 4's hammering cores have
    # fraction ~1)
    mc_active = [0.0, 0.0, 0.0, 0.0]
    mem_frac: dict[int, float] = {}

    # event heap: (finish_time, seq, worker_idx, task)
    events: list = []
    seq = 0

    ready: list[SimTask] = [t for t in tasks if t.deps_remaining == 0]
    pending_spawn = list(tasks)       # program order
    spawned = set()
    completion: list[SimTask] = []
    executed: dict[int, float] = {}   # tid -> finish time
    collected: set[int] = set()

    master_t = 0.0
    rr = 0

    def mc_shares(task: SimTask) -> list[float]:
        """Per-MC byte shares, aligned with ``task.homes``: the measured
        footprint split when the task carries one, an even split else."""
        if task.home_bytes and sum(task.home_bytes) > 0:
            total = sum(task.home_bytes)
            return [task.mem_bytes * b / total for b in task.home_bytes]
        share = task.mem_bytes / max(len(task.homes), 1)
        return [share] * len(task.homes)

    def exec_time(w: WorkerState, task: SimTask) -> tuple[float, float]:
        comp = p.compute_time_s(task.flops)
        shares = mc_shares(task)
        # fused wave kernels (kernel_backend="pallas") keep the task's
        # write-back slice on-chip: only the remaining DRAM fraction
        # contends at the controllers; the on-chip slice moves at MPB
        # line cost (local, hop-free, contention-free — §3.2)
        dram = 1.0
        onchip_s = 0.0
        if task.fused and task.mem_bytes > 0 and task.onchip_bytes > 0:
            dram = (task.mem_bytes - task.onchip_bytes) / task.mem_bytes
            onchip_s = (task.onchip_bytes / p.cacheline_bytes) \
                * p.mpb_write_s(0)
        mem0 = sum(p.mem_time_s(sh * dram, w.mc_hops[mc], concurrent=1)
                   for sh, mc in zip(shares, task.homes))
        f = mem0 / max(mem0 + comp + onchip_s, 1e-12)
        mem_frac[task.tid] = f
        mem = 0.0
        for sh, mc in zip(shares, task.homes):
            conc = 1.0 + max(mc_active[mc], 0.0)   # others + me
            mem += p.mem_time_s(sh * dram, w.mc_hops[mc], concurrent=conc)
        # one fused kernel flushes once per wave, not once per task: the
        # per-task whole-L2 flush/invalidate charge disappears
        fl = (0.0 if task.fused
              else p.seconds(p.flush_cycles + p.invalidate_cycles))
        return comp + mem + onchip_s, fl

    def begin(widx: int, task: SimTask, t0: float):
        """Worker starts executing: contention is sampled NOW (queued
        descriptors in the MPB don't touch memory)."""
        nonlocal seq
        w = workers[widx]
        start = max(w.free_at, t0)
        dur, fl = exec_time(w, task)
        for mc in task.homes:
            mc_active[mc] += mem_frac[task.tid]
        w.running = task
        w.free_at = start + dur + fl
        w.busy_s += dur
        w.flush_s += fl
        w.tasks_run += 1
        seq += 1
        heapq.heappush(events, (w.free_at, seq, widx, task))

    def enqueue(widx: int, task: SimTask, t0: float):
        w = workers[widx]
        w.inflight += 1
        if w.running is None:
            begin(widx, task, t0)
        else:
            w.queue.append(task)

    def try_schedule(task: SimTask, t: float, single_attempt: bool) -> bool:
        """Master appends to a worker's MPB ring (§3.4)."""
        nonlocal rr, master_t
        order = range(len(workers))
        if placement_aware:
            # prefer emptier queues, then closer workers (hop cost)
            order = sorted(order, key=lambda i: (workers[i].inflight,
                                                 mpb_hops[i]))
        else:
            order = [(rr + i) % len(workers) for i in range(len(workers))]
            rr += 1
        for widx in order:
            w = workers[widx]
            if w.inflight < mpb_slots:
                master_t += p.seconds(p.schedule_cycles) + \
                    p.mpb_write_s(mpb_hops[widx])
                enqueue(widx, task, master_t)
                return True
            master_t += p.seconds(p.poll_cycles)   # slot check only
            if single_attempt:
                return False
        return False

    def collect_finished(t_now: float):
        """Pop all finish events up to t_now; mark slots completed."""
        while events and events[0][0] <= t_now:
            ft, _, widx, task = heapq.heappop(events)
            w = workers[widx]
            for mc in task.homes:
                mc_active[mc] -= mem_frac[task.tid]
            w.running = None
            if w.queue:
                begin(widx, w.queue.pop(0), ft)
            w.inflight -= 1
            executed[task.tid] = ft
            completion.append(task)

    def manager_slices(task: SimTask) -> dict[int, float]:
        """Per-manager footprint block counts for one task (manager =
        home % dep_managers; even split when the task carries no
        per-home block counts)."""
        slices: dict[int, float] = {}
        blocks = task.home_blocks \
            if task.home_blocks and len(task.home_blocks) == len(task.homes) \
            else None
        for i, h in enumerate(task.homes):
            m = h % dep_managers
            b = blocks[i] if blocks else task.n_blocks / len(task.homes)
            slices[m] = slices.get(m, 0.0) + b
        return slices

    def dep_line_s(m: int, slots: int = 1) -> float:
        """One direction of manager ``m``'s descriptor traffic, charged
        per 32-byte MPB line.  Unbatched (``dep_batch_lines <= 1``) a
        descriptor rides alone — ``lines_for(slots)`` full line writes,
        exactly the pre-batching charge.  Batched, envelopes pack
        ``DESCRIPTORS_PER_LINE`` descriptors per line, so the amortized
        steady-state charge is ``slots/DESCRIPTORS_PER_LINE`` lines."""
        hops = core_mc_hops(master, m % 4)
        if dep_batch_lines <= 1:
            return lines_for(slots) * p.mpb_write_s(hops)
        return (slots / DESCRIPTORS_PER_LINE) * p.mpb_write_s(hops)

    def spawn_cost(task: SimTask) -> float:
        """Master-side initiation charge (§3.3): central = base + one
        walk over the whole footprint; sharded = base + one MPB
        round-trip per involved manager + the slowest per-manager walk
        (the walks overlap across managers)."""
        if not dep_managers:
            return p.seconds(p.spawn_base_cycles +
                             p.dep_block_cycles * task.n_blocks)
        slices = manager_slices(task)
        t = p.seconds(p.spawn_base_cycles)
        for m in slices:
            # dep_query out + dep_grant back, each one descriptor slot
            t += 2.0 * dep_line_s(m)
        t += p.seconds(p.dep_block_cycles * max(slices.values()))
        return t

    def release_all(t: float):
        nonlocal master_t
        while completion:
            task = completion.pop()
            master_t += p.seconds(p.release_cycles)
            if dep_managers:
                # completion fan-out: one release descriptor per manager
                for m in manager_slices(task):
                    master_t += dep_line_s(m)
            for dep in task.dependents:
                dep.deps_remaining -= 1
                if dep.deps_remaining == 0:
                    ready.append(dep)

    # ---- phase 1: main program spawns every task (running mode, §3.4):
    # one scheduling attempt for the newly spawned task only; on rejection
    # it joins the local ready queue and the main program continues --------
    ready.clear()
    for task in pending_spawn:
        master_t += spawn_cost(task)
        spawned.add(task.tid)
        collect_finished(master_t)
        if task.deps_remaining == 0:
            if not try_schedule(task, master_t, single_attempt=True):
                ready.append(task)

    # ---- phase 2: barrier — polling mode (§3.4 / §3.6) ---------------------
    n_total = len(tasks)
    while len(executed) < n_total or ready or completion:
        progressed = False
        collect_finished(master_t)
        release_all(master_t)
        still = []
        for r in ready:
            master_t += p.seconds(p.poll_cycles)
            if try_schedule(r, master_t, single_attempt=False):
                progressed = True
            else:
                still.append(r)
        ready[:] = still
        if not progressed:
            if events:
                # idle until the next completion
                master_t = max(master_t, events[0][0])
                collect_finished(master_t)
                release_all(master_t)
            elif not ready:
                break
        master_t += p.seconds(p.poll_cycles * len(workers))

    total = max([master_t] + [w.free_at for w in workers])
    idle = [max(total - w.busy_s - w.flush_s, 0.0) for w in workers]
    return SimResult(
        total_s=total,
        worker_busy_s=[w.busy_s for w in workers],
        worker_flush_s=[w.flush_s for w in workers],
        worker_idle_s=idle,
        worker_tasks=[w.tasks_run for w in workers],
        master_busy_s=master_t,
        tasks=len(tasks),
    )


def predict_dep_traffic(events: list[tuple], batch_lines: int,
                        grant_deps: dict[int, int] | None = None) -> dict:
    """Replay the descriptor-line batcher's flush policy over a recorded
    logical stream and predict the wire traffic it produces.

    ``events`` is a ``ShardedDependenceManager(record_traffic=True)``
    ``traffic_log``: ``("desc", home, kind, slots, qid)`` per logical
    descriptor posted (``qid`` numbers queries positionally, ``None``
    for releases), ``("sync",)`` per flush-all point (barriers, wave
    boundaries, ``admit_finish``), and ``("flush", home)`` per *measured*
    envelope — which this replay deliberately ignores: it re-derives
    every flush from the policy alone (capacity ``batch_lines *
    DESCRIPTORS_PER_LINE`` slots, flush-per-descriptor at
    ``batch_lines <= 1``, flush-all at syncs), which is what makes the
    returned counts a prediction that can *disagree* with the measured
    ``dep_batches``/``dep_lines`` if either side drifts.

    ``grant_deps`` is the manager's ``traffic_deps`` (query id -> deps in
    its grant); each query-carrying envelope is answered by exactly one
    grant envelope whose slots are ``grant_slots`` per query.

    The flush policy depends only on the logical stream and the config —
    never on consumer timing — so the prediction must reconcile exactly
    for sync *and* threaded pumps; ``tests/test_torch_depman.py`` asserts
    it does.
    """
    grant_deps = grant_deps or {}
    cap = max(1, batch_lines) * DESCRIPTORS_PER_LINE
    buf_slots: dict[int, int] = {}       # home -> buffered slots
    buf_qids: dict[int, list] = {}       # home -> queries in envelope
    out = {"batches_posted": 0, "lines_posted": 0,
           "batches_granted": 0, "lines_granted": 0}

    def flush(home: int) -> None:
        slots = buf_slots.get(home, 0)
        if not slots:
            return
        out["batches_posted"] += 1
        out["lines_posted"] += lines_for(slots)
        qids = buf_qids.get(home)
        if qids:
            gslots = sum(grant_slots(grant_deps.get(q, 0)) for q in qids)
            out["batches_granted"] += 1
            out["lines_granted"] += lines_for(gslots)
        buf_slots[home] = 0
        buf_qids[home] = []

    for ev in events:
        if ev[0] == "desc":
            _, home, kind, slots, qid = ev
            if buf_slots.get(home, 0) and \
                    buf_slots[home] + slots > cap:
                flush(home)
            buf_slots[home] = buf_slots.get(home, 0) + slots
            if kind == "dep_query":
                buf_qids.setdefault(home, []).append(qid)
            if batch_lines <= 1:
                flush(home)
        elif ev[0] == "sync":
            for home in list(buf_slots):
                flush(home)
    for home in list(buf_slots):         # stream ended mid-envelope
        flush(home)
    out["dep_batches"] = out["batches_posted"] + out["batches_granted"]
    out["dep_lines"] = out["lines_posted"] + out["lines_granted"]
    return out
