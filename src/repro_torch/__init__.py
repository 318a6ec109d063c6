"""BDDT-SCC in PyTorch and CUDA: the port of the JAX package ``repro``.

The same ``@task`` programs, block-level dependence analysis and
executors as ``repro``, with ``BlockArray`` tiles held as torch tensors
on one device (``RuntimeConfig.device``, ``"cuda"`` by default) and the
wave kernels written by hand in CUDA C++ for Hopper (``csrc/``)::

    from repro_torch import RuntimeConfig, TaskRuntime, task

serving loops::

    from repro_torch.serve import ServeConfig, Session

a dense LLM server (prefill through the hand-written flash-attention
kernel, then greedy decode)::

    from repro_torch.launch.serve import generate

and its trainer (chunked-CE loss, remat, AdamW, pytree checkpoints)::

    from repro_torch.launch.train import build_train_step, train_loop

This package imports neither JAX nor ``repro``; ``repro`` stays the
reference the tests hold it against.
"""
from .core import (AccessMode, BlockArray, DEP_MANAGERS, DEP_PUMPS,
                   EXECUTORS, ExecutorKind, DepManagerKind, DepPumpKind,
                   Executor, In, InOut, KERNEL_BACKENDS, KernelBackend,
                   Out, PLACEMENTS, PlacementKind, Region, RuntimeConfig,
                   RuntimeStats, SCHEDULING_POLICIES, STATS_SCHEMA,
                   SchedulingPolicy, ShardedDependenceManager, TaskFuture,
                   TaskRuntime, current_runtime, register_wave_kernel, task,
                   wait_on)

__all__ = [
    # entry points
    "TaskRuntime", "task", "wait_on", "current_runtime",
    # data + footprints
    "BlockArray", "Region", "AccessMode", "In", "Out", "InOut",
    # configuration + results
    "RuntimeConfig", "RuntimeStats", "STATS_SCHEMA", "TaskFuture",
    # typed configuration choices
    "ExecutorKind", "DepManagerKind", "DepPumpKind", "SchedulingPolicy",
    "PlacementKind", "KernelBackend", "EXECUTORS", "DEP_MANAGERS",
    "DEP_PUMPS", "SCHEDULING_POLICIES", "PLACEMENTS", "KERNEL_BACKENDS",
    # extension surfaces
    "Executor", "ShardedDependenceManager", "register_wave_kernel",
]
