"""BDDT-SCC in PyTorch: block-level dynamic dependence analysis + task runtime.

The port of :mod:`repro.core` (the JAX package, the reference) module by
module, with tiles as torch tensors:

* :mod:`api`        — the OmpSs front-end: @task footprints, futures, config
* :mod:`blocks`     — the custom block allocator (BlockArray / Region / In-Out-InOut)
* :mod:`deps`       — block-level dynamic dependence analysis (BDDT)
* :mod:`depman`     — home-sharded dependence managers over MPB channels
* :mod:`graph`      — task descriptors, descriptor pool, ready/completion queues
* :mod:`mpb`        — message-passing-buffer SPSC descriptor rings
* :mod:`scheduler`  — the master's running/polling modes + lazy release
* :mod:`executor`   — sequential (oracle) / host (master + worker threads) /
  staged (wavefront batching) execution
* :mod:`sharded`    — home-aware mesh execution (owner-computes over the
  ``repro_torch.dist`` mesh)
* :mod:`wavekernel` — the registry of hand-written wave kernels
* :mod:`placement`  — memory-controller striping -> block-cyclic device
  placement
* :mod:`costmodel`  — SCC latency/contention model (Figs 3-4) + the H100
  roofline constants
* :mod:`sim`        — discrete-event simulation of the SCC runtime
  (``executor="sim"``)
* :mod:`calibrate`  — the cost model fitted to the paper's
  microbenchmarks, with its trend checks
"""
from .api import (DEP_MANAGERS, DEP_PUMPS, EXECUTORS, KERNEL_BACKENDS,
                  PLACEMENTS, SCHEDULING_POLICIES, STATS_SCHEMA,
                  DepManagerKind, DepPumpKind, ExecutorKind, KernelBackend,
                  PlacementKind, RuntimeConfig, RuntimeStats,
                  SchedulingPolicy, TaskFuture, current_runtime, task,
                  wait_on)
from .blocks import (AccessMode, BlockArray, In, InOut, Out, Region,
                     coerce_mode)
from .costmodel import H100Params, SCCParams
from .depman import ShardedDependenceManager
from .executor import Executor
from .runtime import TaskRuntime
from .sim import (FlopcountCost, SimExecutor, SimResult, SimTask,
                  predict_dep_traffic, sequential_time, simulate)
from .wavekernel import register_wave_kernel

__all__ = [
    # entry points
    "TaskRuntime", "task", "wait_on", "current_runtime",
    # data + footprints
    "BlockArray", "Region", "AccessMode", "In", "Out", "InOut",
    "coerce_mode",
    # configuration + results
    "RuntimeConfig", "RuntimeStats", "STATS_SCHEMA", "TaskFuture",
    # typed configuration choices (one source for every stringly field)
    "ExecutorKind", "DepManagerKind", "DepPumpKind", "SchedulingPolicy",
    "PlacementKind", "KernelBackend", "EXECUTORS", "DEP_MANAGERS",
    "DEP_PUMPS", "SCHEDULING_POLICIES", "PLACEMENTS", "KERNEL_BACKENDS",
    # extension surfaces
    "Executor", "ShardedDependenceManager", "register_wave_kernel",
    # the timing-only sim executor and its cost model
    "SimExecutor", "SimTask", "SimResult", "FlopcountCost", "simulate",
    "sequential_time", "predict_dep_traffic", "SCCParams", "H100Params",
]
