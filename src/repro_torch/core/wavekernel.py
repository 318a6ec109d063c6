"""Wave kernels: one hand-written kernel launch per grouped wave.

The paper's §3.2 performance argument is that a wave's tasks should run
out of fast on-chip memory instead of round-tripping every operand
through shared DRAM.  The staged executor fuses a wavefront's identical
tile tasks into one batched dispatch; the JAX package goes one level
down by lowering an eligible group into a single Pallas grid whose axis
is the task axis, with the unchanged task body run on each task's tiles.

A hand-written CUDA kernel cannot run an arbitrary Python body, so here
the layer is a **registry**: :func:`register_wave_kernel` maps a task body
to a batched kernel whose task axis is the launch grid's outermost axis.
The batched function takes the group's stacked operands in the staged
stacking order — READS args, then firstprivate scalars as ``(n,)``
tensors — plus ``out_shapes`` (one per-task output shape per WRITES
arg), and returns the stacked outputs (one tensor for one output, a
tuple for several).

Selection is ``RuntimeConfig.kernel_backend``: ``"xla"`` (the default)
is the ``torch.func.vmap`` path, ``"pallas"`` tries the registry per
group.  An ineligible group (:func:`eligibility`, the reference's reasons
in the reference's order) or an eligible one whose body has no entry
(``"no_kernel"``) falls back to the vmap path, counted in
``RuntimeStats.kernel_fallbacks`` and named on a ``kernel_dispatch``
event.  There is no catch-all fallback for registered bodies: on CUDA a
kernel that fails to build or launch raises.

The reference's bit-exactness contract does not carry over: a
hand-written kernel sums in another order than the vmap path's library
calls, so this backend is held to the kernels' stated tolerances.
"""
from __future__ import annotations

import weakref
from typing import Callable, Sequence

import numpy as np
import torch

from .graph import TaskDescriptor

__all__ = ["MAX_GRID_TASKS", "group_signature", "eligibility",
           "register_wave_kernel", "wave_kernel_for", "stage_dtype"]

# One launch per fused wave: groups larger than this take the vmap
# fallback ("grid_overflow"), the reference's bound kept so the two
# backends group and fall back identically.  Kernels split a launch over
# CUDA's 65,535 limit on the grid's z axis themselves.
MAX_GRID_TASKS = 65536

# task body -> batched kernel; weak keys, so a body defined inside an app
# call (a closure) leaves the registry when the app's runtime is gone
_REGISTRY: "weakref.WeakKeyDictionary[Callable, Callable]" = \
    weakref.WeakKeyDictionary()

# JAX's dtype canonicalization with 64-bit mode off
_CANONICAL_NP = {
    np.dtype(np.int64): np.dtype(np.int32),
    np.dtype(np.uint64): np.dtype(np.uint32),
    np.dtype(np.float64): np.dtype(np.float32),
    np.dtype(np.complex128): np.dtype(np.complex64),
}


def _value_dtype(v) -> np.dtype:
    """The canonical (JAX, x64 off) dtype of one firstprivate value."""
    if isinstance(v, torch.Tensor):
        dt = np.dtype(str(v.dtype).removeprefix("torch."))
    else:
        dt = np.result_type(v)
    return _CANONICAL_NP.get(dt, dt)


def stage_dtype(v) -> torch.dtype:
    """The torch dtype a firstprivate value is staged as: the canonical
    dtype of its grouping key, with integers widened to int64 (torch's
    index dtype), so every task of one group stages alike."""
    dt = _value_dtype(v)
    if dt.kind in "iu":
        return torch.int64
    return torch.from_numpy(np.zeros(0, dt)).dtype


def group_signature(td: TaskDescriptor) -> tuple:
    """The wave-grouping key: function identity plus the *structure* of
    the footprint and the firstprivate values (shapes/dtypes, never the
    values themselves) — tasks that differ only in region contents or
    index values share one batched dispatch.

    The firstprivate dtype is the reference's canonical one (a Python
    int keys as int32, a float as float32), so groups are the
    reference's groups whatever dtype the value is staged as."""
    parts: list = [td.fn]
    for m in td.args:
        parts.append((type(m).__name__, m.region.shape,
                      str(m.region.array.dtype)))
    for v in td.values:
        parts.append(("firstprivate", np.shape(v), str(_value_dtype(v))))
    return tuple(parts)


def eligibility(group: Sequence[TaskDescriptor]) -> str | None:
    """Can this group launch as one wave kernel?  ``None`` means eligible;
    otherwise the named fallback reason recorded in
    ``RuntimeStats.kernel_fallbacks`` and the ``kernel_dispatch`` event.
    Same reasons, same order as the reference:

    * ``"single_task"``    — a 1-task group; a fused launch buys nothing
      over the plain call.
    * ``"grid_overflow"``  — more tasks than :data:`MAX_GRID_TASKS`.
    * ``"non_rectangular"``— a footprint region that is not a rank-2
      rectangle of tiles.
    * ``"mixed_dtype"``    — operand/output regions disagree on dtype.
    * ``"nonscalar_firstprivate"`` — an index parameter that is not a
      scalar; scalars ride the launch as ``(n,)`` operands.

    The registry check (``"no_kernel"``) comes after these, in the
    executor.
    """
    if len(group) == 1:
        return "single_task"
    if len(group) > MAX_GRID_TASKS:
        return "grid_overflow"
    td = group[0]
    dtypes = set()
    for m in td.args:
        spec = m.region.footprint_spec()
        if spec.rank != 2:
            return "non_rectangular"
        dtypes.add(spec.dtype)
    if len(dtypes) > 1:
        return "mixed_dtype"
    for v in td.values:
        if np.shape(v) != ():
            return "nonscalar_firstprivate"
    return None


def _body(task_fn: Callable) -> Callable:
    """The raw function a ``@task`` wrapper spawns (``TaskFn.fn``)."""
    return getattr(task_fn, "__wrapped__", task_fn)


def register_wave_kernel(task_fn: Callable, batched_fn: Callable) -> None:
    """Launch ``batched_fn`` for every eligible group of ``task_fn``
    (a ``@task`` function or its raw body) under
    ``kernel_backend="pallas"``.  ``batched_fn(*stacked, out_shapes)``
    sees the group's stacked operands, task axis first."""
    _REGISTRY[_body(task_fn)] = batched_fn


def wave_kernel_for(fn: Callable) -> Callable | None:
    """The batched kernel registered for task body ``fn``, or None."""
    return _REGISTRY.get(_body(fn))
