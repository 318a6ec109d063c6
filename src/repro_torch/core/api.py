"""The declarative OmpSs-style front-end: ``@task`` footprint decorators,
firstprivate value parameters, task futures, and runtime configuration.

The paper's programming model is a pragma on the *function*: each argument
is annotated ``in`` / ``out`` / ``inout`` once, and every call site spawns
a task whose footprint the runtime synchronizes automatically.  This module
is that front-end in Python::

    from repro_torch.core import TaskRuntime, task

    @task(inout="c", in_=("a", "b"))
    def gemm(c, a, b):
        return c + a @ b

    with TaskRuntime(executor="staged", device="cuda") as rt:
        A = rt.from_array(a, (64, 64))
        B = rt.from_array(b, (64, 64))
        C = rt.zeros((n, n), (64, 64))
        for i in range(g):
            for j in range(g):
                for k in range(g):
                    gemm(C[i, j], A[i, k], B[k, j])   # spawns a task
        rt.wait_on(C[0, 0])        # region-scoped taskwait (§3.3 sync)
        ...                        # exit barrier drains the rest

Scalar parameters — tile offsets, iteration indices, coefficients — are
declared ``firstprivate`` (OmpSs's by-value capture) and bound at the spawn
site like any other argument; the value is copied into the task descriptor,
never synchronized on::

    @task(in_="halo", out="dest", firstprivate=("r0", "c0"))
    def stencil(halo, r0, c0, dest=None):
        return dynamic_slice2d(step(halo), r0, c0, T, T)

    stencil(S[i0:i1, j0:j1], r0, c0, D[i, j])   # r0/c0 ride in the task

Because the function object is shared across spawn sites (no per-value
closures), the staged executor batches same-shape instances of a wavefront
into one ``torch.func.vmap(fn)`` dispatch, stacking the firstprivate values
as extra vmap operands.

Calling a decorated function *outside* a runtime scope with plain tensors
runs it eagerly — the decorated function is its own serial-elision
reference.

Spawns return a :class:`TaskFuture`; ``future.result()`` forces only that
task's dependence cone, not the whole graph.  :class:`RuntimeConfig`
gathers what used to be nine ``TaskRuntime.__init__`` kwargs, and
:class:`RuntimeStats` is the typed replacement for the old ``stats()``
dict (the dict-style access window has closed; use attributes).
"""
from __future__ import annotations

import contextlib
import dataclasses
import enum
import inspect
import threading
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from .blocks import (AccessMode, BlockArray, In, InOut, MODE_CLASSES, Out,
                     Region, coerce_mode)
from .graph import TaskDescriptor

__all__ = ["task", "TaskFn", "TaskFuture", "RuntimeConfig", "RuntimeStats",
           "STATS_SCHEMA", "current_runtime", "wait_on",
           "ExecutorKind", "DepManagerKind", "DepPumpKind",
           "SchedulingPolicy", "PlacementKind", "KernelBackend",
           "EXECUTORS", "DEP_MANAGERS", "DEP_PUMPS",
           "SCHEDULING_POLICIES", "PLACEMENTS", "KERNEL_BACKENDS"]


# ---------------------------------------------------------------------------
# the ambient runtime scope (``with rt:``)
_scope = threading.local()


def current_runtime():
    """The innermost active ``TaskRuntime`` on this thread, or None.

    Worker threads never see a scope (it is thread-local), so a task body
    that calls another ``@task`` function runs it eagerly instead of
    recursively spawning — master-only task initiation, as in the paper.
    """
    stack = getattr(_scope, "stack", None)
    return stack[-1] if stack else None


def _push_runtime(rt) -> None:
    stack = getattr(_scope, "stack", None)
    if stack is None:
        stack = _scope.stack = []
    stack.append(rt)


def _pop_runtime(rt) -> None:
    stack = getattr(_scope, "stack", [])
    if not stack or stack[-1] is not rt:
        raise RuntimeError("runtime scope exited out of order")
    stack.pop()


@contextlib.contextmanager
def suspend_runtime_scope():
    """Mask the ambient scope while a task body executes.

    Sequential and staged executors run task bodies on the master
    thread, where the spawning scope is still active; without masking, a
    body that calls another ``@task`` function would recursively spawn
    there but run eagerly on a host worker — same program, different
    executors, different behavior.  Masking restores master-only task
    initiation everywhere."""
    stack = getattr(_scope, "stack", None)
    saved = stack[:] if stack else []
    if stack:
        stack.clear()
    try:
        yield
    finally:
        if saved:
            stack = getattr(_scope, "stack", None)
            if stack is None:
                stack = _scope.stack = []
            stack[:] = saved


def wait_on(*regions, mode="in"):
    """Region-scoped taskwait on the ambient runtime (§3.3 sync).

    The module-level spelling of ``rt.wait_on`` for code inside a
    ``with rt:`` scope: blocks until every task whose footprint
    conflicts with ``regions`` under ``mode`` has completed.  ``mode``
    accepts ``"in"``/``"out"``/``"inout"`` or an ``AccessMode`` member
    (``AccessMode.IN`` waits for writers only; ``OUT``/``INOUT`` wait
    for readers too).
    """
    rt = current_runtime()
    if rt is None:
        raise RuntimeError(
            "wait_on: no active runtime scope — call it inside "
            "`with rt:` (or use rt.wait_on(...) on a runtime directly)")
    return rt.wait_on(*regions, mode=mode)


# ---------------------------------------------------------------------------
# configuration choices — every stringly-typed ``RuntimeConfig`` field is
# backed by exactly one enum here; ``validate()``, the executor factory,
# the registries (``scheduler.POLICIES``, ``placement.PLACEMENTS``) and
# the docs all read the same lists, so they cannot drift.  Members are
# ``str`` subclasses: ``ExecutorKind.HOST == "host"``, hashes like the
# plain string, and formats as the bare value — plain strings keep
# working everywhere an enum is accepted.
class _ChoiceEnum(str, enum.Enum):
    def __str__(self) -> str:
        return self.value


class ExecutorKind(_ChoiceEnum):
    """``RuntimeConfig.executor`` — which execution engine runs tasks."""
    SEQUENTIAL = "sequential"
    HOST = "host"
    STAGED = "staged"
    SIM = "sim"
    SHARDED = "sharded"


class DepManagerKind(_ChoiceEnum):
    """``RuntimeConfig.dep_manager`` — central analyzer vs per-home
    sharded managers (bit-identical schedules)."""
    CENTRAL = "central"
    SHARDED = "sharded"


class DepPumpKind(_ChoiceEnum):
    """``RuntimeConfig.dep_pump`` — how sharded home managers are
    pumped: inline on the master (``sync``), on per-home worker threads
    (``threaded``), or resolved from ``REPRO_DEPMAN_THREADS`` at runtime
    construction (``auto``, the default).  Bit-identical schedules and
    dependence counts either way."""
    AUTO = "auto"
    SYNC = "sync"
    THREADED = "threaded"


class SchedulingPolicy(_ChoiceEnum):
    """``RuntimeConfig.policy`` — running-mode ready-queue policy (§3.4)."""
    ROUND_ROBIN = "round_robin"
    LOCALITY = "locality"
    RANDOM = "random"


class PlacementKind(_ChoiceEnum):
    """``RuntimeConfig.placement`` — block → memory-controller map."""
    SINGLE = "single"
    STRIPED = "striped"
    STRIPED_DIAG = "striped_diag"
    STRIPED_ROWS = "striped_rows"


class KernelBackend(_ChoiceEnum):
    """``RuntimeConfig.kernel_backend`` — grouped-wave dispatch path."""
    XLA = "xla"
    PALLAS = "pallas"


EXECUTORS = tuple(m.value for m in ExecutorKind)
DEP_MANAGERS = tuple(m.value for m in DepManagerKind)
DEP_PUMPS = tuple(m.value for m in DepPumpKind)
SCHEDULING_POLICIES = tuple(m.value for m in SchedulingPolicy)
PLACEMENTS = tuple(m.value for m in PlacementKind)
KERNEL_BACKENDS = tuple(m.value for m in KernelBackend)

_EXECUTORS = EXECUTORS        # pre-redesign private alias


def _check_choice(field: str, value, choices: tuple[str, ...]) -> str:
    """Validate one choice field; enum members (this package's or any
    other ``str`` enum with the same values) normalize to their value."""
    if isinstance(value, enum.Enum):
        value = value.value
    if value not in choices:
        raise ValueError(f"{field} must be one of {choices}, "
                         f"got {value!r}")
    return value


#: executors this slice does not port, and the ROADMAP.md
#: queue 1 item that brings each one; asking for them raises
#: ``NotImplementedError`` instead of substituting another executor
UNPORTED = {
    ("executor", "sharded"):
        "ROADMAP.md queue 1 item 9 (sharded executor and mesh layer)",
}


@dataclass(frozen=True)
class RuntimeConfig:
    """Everything that shapes a :class:`~repro_torch.core.TaskRuntime`.

    Field names, defaults and choice strings are the JAX package's, so a
    configuration carries across unchanged (``repro_torch.interop``).
    Every choice field accepts the plain string or the matching typed
    member, and ``validate()`` normalizes members to their string values.

    * ``executor``    — "host" (the default: master + worker threads over
      MPB rings), "sequential" (serial-elision oracle), "staged"
      (wavefront batching) or "sim" (the timing-only DES: the real task
      program's DAG replayed on the SCC cost model, ``core/sim.py``; no
      task output is computed and no kernel launches).  "sharded" is a
      valid spelling that this port does not run yet: the runtime raises
      ``NotImplementedError`` naming its ``ROADMAP.md`` item
      (:data:`UNPORTED`).
    * ``n_workers`` / ``mpb_slots`` — worker count and per-worker MPB ring
      depth (§3.2).
    * ``pool_capacity`` — pre-allocated task-descriptor pool (§3.3).
    * ``dep_manager`` — "central" (one master-side
      ``DependenceAnalyzer``, the paper's §3.3 loop) or "sharded" (one
      ``HomeManager`` per block home behind MPB channels,
      ``core/depman.py``, ``n_controllers`` homes).
    * ``dep_pump`` / ``dep_batch_lines`` — the sharded manager's pumping
      ("sync": the master services the managers inline; "threaded": one
      pump thread per home; "auto": threaded iff ``REPRO_DEPMAN_THREADS``
      is a positive integer) and descriptor batching (MPB lines per
      envelope); validated, inert under "central".
    * ``policy``      — running-mode scheduling policy (§3.4).
    * ``placement`` / ``n_controllers`` — block -> memory-controller map.
    * ``owner_skew_threshold`` — sharded executor only; validated, inert.
    * ``group_waves`` — staged executor: fuse identical tile tasks of a
      wavefront into one batched dispatch.
    * ``kernel_backend`` — how a grouped wave dispatches: ``"xla"`` (the
      default, named for the reference's path: here one
      ``torch.func.vmap(fn)`` call) or ``"pallas"`` (named for the
      reference's fused Pallas grid: here the hand-written wave kernel
      registered for the task body, ``core/wavekernel.py``, launched once
      per group with the task axis as its outermost grid axis).
      Ineligible groups, and eligible groups whose body has no registered
      kernel (``"no_kernel"``), fall back to the vmap path; the runtime
      counts them in ``RuntimeStats.kernel_fallbacks`` and tags each
      decision with a ``kernel_dispatch`` tracker event.
    * ``sim_cost_fn`` / ``sim_params`` — "sim" executor only: a per-task
      ``(flops, bytes)`` cost function of a descriptor (default
      ``sim.FlopcountCost``) and the ``costmodel.SCCParams`` the DES runs
      on (default ``SCCParams()``); inert under the other executors.
    * ``tracker`` — the observability sink (``repro_torch.obs``): None
      (off, the default), a spec string (``"memory"``, ``"console"``,
      ``"jsonl"``, ``"jsonl:PATH"``) or a ready ``Tracker`` instance.
    * ``profile_waves`` — wrap each staged wave dispatch in a
      ``torch.profiler.record_function`` range so profiles name waves.
    * ``worker_cache_tiles`` — host executor: each worker's pinned tile
      cache holds up to this many assembled READS regions (0 = off).
    * ``device``      — where tiles live and kernels run: ``"cuda"`` (the
      default; the runtime raises when CUDA is absent, it never carries
      on on the CPU by itself) or ``"cpu"``, which runs every kernel's
      plain PyTorch version.  The one field the JAX package lacks.
    """
    executor: str | ExecutorKind = "host"
    n_workers: int = 4
    mpb_slots: int = 16
    pool_capacity: int = 4096
    dep_manager: str | DepManagerKind = "central"
    dep_pump: str | DepPumpKind = "auto"
    dep_batch_lines: int = 4
    policy: str | SchedulingPolicy = "round_robin"
    placement: str | PlacementKind = "striped"
    n_controllers: int = 4
    owner_skew_threshold: float = 0.0
    group_waves: bool = True
    kernel_backend: str | KernelBackend = "xla"
    seed: int = 0
    sim_cost_fn: Callable | None = None
    sim_params: object | None = None
    tracker: object | None = None
    profile_waves: bool = False
    worker_cache_tiles: int = 64
    device: str = "cuda"

    #: choice field → (enum type, canonical values); the single source
    #: the validator and the docs read
    CHOICES = {
        "executor": (ExecutorKind, EXECUTORS),
        "dep_manager": (DepManagerKind, DEP_MANAGERS),
        "dep_pump": (DepPumpKind, DEP_PUMPS),
        "policy": (SchedulingPolicy, SCHEDULING_POLICIES),
        "placement": (PlacementKind, PLACEMENTS),
        "kernel_backend": (KernelBackend, KERNEL_BACKENDS),
    }

    def validate(self) -> "RuntimeConfig":
        """Check every field and return a normalized copy: enum members
        in choice fields come back as their plain-string values, so the
        runtime internals only ever see canonical strings."""
        norm = {fld: _check_choice(fld, getattr(self, fld), choices)
                for fld, (_, choices) in self.CHOICES.items()}
        cfg = self if all(norm[f] == getattr(self, f) and
                          type(getattr(self, f)) is str
                          for f in norm) \
            else dataclasses.replace(self, **norm)
        for fld in ("n_workers", "mpb_slots", "pool_capacity",
                    "n_controllers", "dep_batch_lines"):
            if getattr(cfg, fld) < 1:
                raise ValueError(f"{fld} must be >= 1")
        if cfg.owner_skew_threshold < 0:
            raise ValueError("owner_skew_threshold must be >= 0 (0 = off)")
        if cfg.worker_cache_tiles < 0:
            raise ValueError("worker_cache_tiles must be >= 0 (0 = off)")
        if isinstance(cfg.tracker, str):
            from ..obs.tracker import validate_spec
            validate_spec(cfg.tracker)
        elif cfg.tracker is not None and \
                not hasattr(cfg.tracker, "emit"):
            raise ValueError("tracker must be a spec string, a Tracker "
                             "instance, or None")
        try:
            kind = torch.device(cfg.device).type
        except RuntimeError:
            kind = None
        if kind not in ("cuda", "cpu"):
            raise ValueError(f"device must be a cuda or cpu device, "
                             f"got {cfg.device!r}")
        return cfg

    def replace(self, **overrides) -> "RuntimeConfig":
        return dataclasses.replace(self, **overrides)


# ---------------------------------------------------------------------------
# statistics
STATS_SCHEMA = "bddt-scc-stats/1"


@dataclass
class RuntimeStats:
    """Typed runtime instrumentation (was: an ad-hoc ``stats()`` dict;
    the dict-style ``stats[...]``/``.get`` window closed after the
    benchmarks moved to attribute access — use the fields, or
    ``as_dict()`` for serialization).

    Core counters always present; executor-specific fields are None when
    the executor does not produce them.
    """
    tasks_spawned: int = 0
    tasks_scheduled: int = 0
    polling_rounds: int = 0
    blocks_walked: int = 0
    deps_found: int = 0
    spawn_time_s: float = 0.0
    barrier_time_s: float = 0.0
    wait_time_s: float = 0.0
    region_waits: int = 0
    futures_resolved: int = 0
    mpb_full_rejections: int = 0
    # host executor
    worker_busy_s: list[float] | None = None
    worker_tasks: list[int] | None = None
    # host executor: per-worker pinned tile-cache counters (None unless
    # the host executor ran; all-zero hits when the cache is disabled)
    worker_cache_hits: list[int] | None = None
    worker_cache_misses: list[int] | None = None
    # staged / sharded executors
    waves: int | None = None
    grouped_dispatches: int | None = None
    # wave-kernel backend (kernel_backend="pallas"): groups launched as
    # one hand-written wave kernel vs groups that took the vmap fallback
    # (both None under kernel_backend="xla", where the layer is inert).
    # The field set is the reference's schema, so executors this slice
    # does not port keep their (None) fields.
    kernel_dispatches: int | None = None
    kernel_fallbacks: int | None = None
    # sharded executor: owner-computes traffic accounting (§4.1-§4.2
    # generalized — cross-home bytes are what the DES charges contention
    # for) plus how many grouped dispatches went through the
    # shard_map/vmap hybrid
    sharded_dispatches: int | None = None
    cross_home_bytes: int | None = None
    local_home_bytes: int | None = None
    owner_overrides: int | None = None
    # residency accounting, measured at the memory layer (``TileTraffic``)
    # and shared by every executor: actual cross-device tile transfers,
    # not footprint estimates.  ``bytes_staged`` counts bytes harmonized
    # through a device nobody declared (the legacy staging hop) — the
    # device-resident sharded path keeps it at zero.  Under the
    # timing-only sim executor ``tile_moves`` is the DES's *predicted*
    # count of cross-home block fetches for the same footprints.
    tile_moves: int | None = None
    bytes_moved: int | None = None
    bytes_staged: int | None = None
    # sharded dependence manager: total dep_query/dep_grant/release
    # messages over the MPB channels, and per-manager admission counts
    # (None under the central analyzer).  ``dep_messages`` counts
    # *logical* descriptors regardless of batching; ``dep_batches`` the
    # multi-descriptor envelopes actually sent (== dep_messages when
    # ``dep_batch_lines=1``, strictly fewer when batching engages);
    # ``dep_lines`` the 32-byte MPB lines those envelopes occupied;
    # ``pump_wall_s`` the wall seconds spent inside manager servicing
    # (pump-thread busy time under dep_pump="threaded", the master's
    # inline service time under "sync")
    dep_messages: int | None = None
    dep_batches: int | None = None
    dep_lines: int | None = None
    pump_wall_s: float | None = None
    manager_admissions: list[int] | None = None
    # serving admission controller (``repro.serve``): request counters
    # and the in-flight footprint high-water mark against the byte
    # budget.  All None unless a ``Session`` attached an
    # ``AdmissionController`` to the runtime; the invariant
    # ``submitted == admitted + rejected`` holds once the session
    # closes (still-queued requests resolve to rejected).
    admission_submitted: int | None = None
    admission_admitted: int | None = None
    admission_rejected: int | None = None
    admission_deferred: int | None = None
    admission_peak_bytes: int | None = None
    admission_budget_bytes: int | None = None
    # sim executor
    predicted_total_s: float | None = None

    def as_dict(self) -> dict:
        return {k: v for k, v in dataclasses.asdict(self).items()
                if v is not None}

    # -- the stable serialization schema (``bddt-scc-stats/1``) ----------
    # One schema shared by ``to_json``, the tracker's ``stats`` event
    # payload (``ConsoleTracker`` summarizes it), and the benchmark
    # report's table input — so consumers stop reaching into attributes
    # ad hoc and a field rename is a schema decision, not an accident.
    def to_dict(self) -> dict:
        """The schema-tagged dict (None fields dropped; absent = None on
        the way back in, so the round-trip is exact)."""
        return {"schema": STATS_SCHEMA, **self.as_dict()}

    def to_json(self) -> str:
        import json
        return json.dumps(self.to_dict(), sort_keys=True)

    @classmethod
    def from_dict(cls, d: dict) -> "RuntimeStats":
        d = dict(d)
        schema = d.pop("schema", None)
        if schema != STATS_SCHEMA:
            raise ValueError(f"stats schema is {schema!r}, "
                             f"expected {STATS_SCHEMA!r}")
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = sorted(set(d) - known)
        if unknown:
            raise ValueError(f"unknown RuntimeStats fields {unknown} "
                             f"(schema {STATS_SCHEMA})")
        return cls(**d)

    @classmethod
    def from_json(cls, s: str) -> "RuntimeStats":
        import json
        return cls.from_dict(json.loads(s))

    @property
    def spawn_us_per_task(self) -> float:
        if not self.tasks_spawned:
            return 0.0
        return 1e6 * self.spawn_time_s / self.tasks_spawned


# ---------------------------------------------------------------------------
# futures
class TaskFuture:
    """A handle on one spawned task.

    ``result()`` synchronizes on *this task only*: the executor runs (or
    waits for) the task's dependence cone and leaves every unrelated
    pending task alone, then returns the task's output value(s) — one
    array per ``out``/``inout`` argument, in argument order.
    """

    __slots__ = ("_rt", "_td")

    def __init__(self, rt, td: TaskDescriptor):
        self._rt = rt
        self._td = td

    # -- introspection ------------------------------------------------------
    @property
    def descriptor(self) -> TaskDescriptor:
        return self._td

    @property
    def tid(self) -> int:
        return self._td.tid

    @property
    def name(self) -> str:
        return self._td.name or self._td.fn.__name__

    @property
    def exec_order(self) -> int | None:
        return self._td.exec_order

    def done(self) -> bool:
        """True once the task executed (its outputs are in place)."""
        return self._td.is_complete

    # -- synchronization ----------------------------------------------------
    def wait(self) -> "TaskFuture":
        """Block until done, forcing only this task's dependence cone."""
        if not self._td.is_complete:
            self._rt._wait_tasks([self._td], kind="future")
        return self

    def result(self):
        """Wait, then return the value(s) *this task* produced.

        Outputs are captured at execution, so the result is deterministic
        across executors and immune to later writers overwriting the same
        region (read the region itself for current-memory semantics)."""
        self.wait()
        outs = self._td.output_values
        if outs is None:
            raise RuntimeError(
                f"task {self.name}#{self.tid} completed without captured "
                "outputs — executor='sim' is timing-only and never "
                "computes task values")
        if not outs:
            return None
        return outs[0] if len(outs) == 1 else tuple(outs)

    def __repr__(self):
        return f"<TaskFuture {self.name}#{self.tid} " \
               f"{'done' if self.done() else 'pending'}>"


# ---------------------------------------------------------------------------
# the @task decorator
def _names(arg) -> tuple[str, ...]:
    if arg is None:
        return ()
    if isinstance(arg, str):
        return (arg,)
    return tuple(arg)


def _is_numeric_value(v) -> bool:
    """True for the by-value types every executor accepts: Python/NumPy/
    torch numeric scalars and arrays (bool, int, uint, float, complex)."""
    if isinstance(v, (bool, int, float, complex)):
        return True
    if isinstance(v, (np.ndarray, np.generic)):
        return np.dtype(v.dtype).kind in "biufc"
    return isinstance(v, torch.Tensor)      # every torch dtype is numeric


def as_region(value, param: str) -> Region:
    if isinstance(value, Region):
        return value
    if isinstance(value, BlockArray):
        return value.whole
    if isinstance(value, AccessMode):
        raise TypeError(
            f"parameter {param!r}: pass the region directly (e.g. A[i, j]) "
            "— the @task decorator already declares the access mode")
    raise TypeError(
        f"parameter {param!r}: expected a Region (e.g. A[i, j]) or "
        f"BlockArray, got {type(value).__name__}")


class TaskFn:
    """A function with a declared footprint; calling it spawns a task.

    Footprint parameters (``in_``/``out``/``inout``) receive block regions
    at spawn sites and are what the runtime synchronizes on; firstprivate
    parameters receive plain values that are copied into the descriptor
    (OmpSs by-value capture) and handed to the body at execution.
    """

    def __init__(self, fn: Callable, in_=(), out=(), inout=(),
                 firstprivate=()):
        self.fn = fn
        self.__name__ = fn.__name__
        self.__doc__ = fn.__doc__
        self.__wrapped__ = fn
        self._sig = inspect.signature(fn)
        modes: dict[str, type[AccessMode]] = {}
        for names, mode in ((_names(in_), In), (_names(out), Out),
                            (_names(inout), InOut)):
            for n in names:
                if n in modes:
                    raise ValueError(
                        f"@task({fn.__name__}): parameter {n!r} declared "
                        "in more than one footprint list")
                if n not in self._sig.parameters:
                    raise ValueError(
                        f"@task({fn.__name__}): no parameter named {n!r} "
                        f"(has {tuple(self._sig.parameters)})")
                modes[n] = mode
        fp_set: set[str] = set()
        for n in _names(firstprivate):
            if n in modes or n in fp_set:
                raise ValueError(
                    f"@task({fn.__name__}): parameter {n!r} declared "
                    "both firstprivate and in a footprint list"
                    if n in modes else
                    f"@task({fn.__name__}): firstprivate parameter {n!r} "
                    "declared twice")
            if n not in self._sig.parameters:
                raise ValueError(
                    f"@task({fn.__name__}): no parameter named {n!r} "
                    f"(has {tuple(self._sig.parameters)})")
            fp_set.add(n)
        # params without a footprint or firstprivate declaration must
        # carry defaults (closure-capture idiom, e.g. ``def f(x,
        # dest=None, _i=i)``); they are never bound at spawn sites
        missing = [n for n, p in self._sig.parameters.items()
                   if n not in modes and n not in fp_set
                   and p.default is inspect.Parameter.empty]
        if missing:
            raise ValueError(
                f"@task({fn.__name__}): every required parameter needs a "
                f"footprint (in_/out/inout) or a firstprivate "
                f"declaration; missing {missing}")
        if not any(m.WRITES for m in modes.values()):
            raise ValueError(
                f"@task({fn.__name__}): at least one out/inout parameter "
                "is required (tasks communicate through their footprints)")
        # argument order == parameter order, the TaskDescriptor contract:
        # at execution the runtime calls fn(*reads_values, *values), so
        # the READS params (in_/inout) must be exactly the leading
        # positional params, firstprivate params must directly follow
        # them, and everything after (out-only params, closure captures)
        # must carry defaults since it receives no value
        params = list(self._sig.parameters)
        reads = [n for n in params if n in modes and modes[n].READS]
        if params[:len(reads)] != reads:
            raise ValueError(
                f"@task({fn.__name__}): in_/inout parameters must come "
                f"first in the signature (the task body receives their "
                f"values positionally); got order {params}")
        fp = [n for n in params if n in fp_set]
        if params[len(reads):len(reads) + len(fp)] != fp:
            raise ValueError(
                f"@task({fn.__name__}): firstprivate parameters must "
                f"directly follow the in_/inout parameters (the task "
                f"body receives their values positionally); got order "
                f"{params}")
        for n in params[len(reads) + len(fp):]:
            if self._sig.parameters[n].default is inspect.Parameter.empty:
                raise ValueError(
                    f"@task({fn.__name__}): parameter {n!r} receives no "
                    f"value at execution (it is not in_/inout/"
                    f"firstprivate) and must declare a default, "
                    f"e.g. {n}=None")
        self.modes = {n: modes[n] for n in params if n in modes}
        self.firstprivate = tuple(fp)

    def _bind_values(self, bound) -> tuple:
        """The firstprivate values of one spawn, in parameter order."""
        values = []
        for n in self.firstprivate:
            if n in bound.arguments:
                v = bound.arguments[n]
            else:
                v = self._sig.parameters[n].default
                if v is inspect.Parameter.empty:
                    raise TypeError(
                        f"{self.__name__}: firstprivate parameter {n!r} "
                        f"needs a value at the call site (or a default "
                        f"in the signature)")
            if isinstance(v, (Region, BlockArray, AccessMode)):
                raise TypeError(
                    f"{self.__name__}: firstprivate parameter {n!r} is "
                    f"passed by value, got {type(v).__name__} — block "
                    "regions belong in in_/out/inout footprints")
            if not _is_numeric_value(v):
                # reject at the spawn site, uniformly across executors —
                # a non-numeric value would only blow up later inside the
                # staged executor's vmap, far from this call
                raise TypeError(
                    f"{self.__name__}: firstprivate parameter {n!r} must "
                    f"be a numeric scalar or array (it is staged through "
                    f"vmap), got {type(v).__name__}")
            if type(v) is int:
                # the reference's bound: JAX's canonical integer (int32
                # with 64-bit mode off), so one program is legal in both
                info = np.iinfo(np.int32)
                if not info.min <= v <= info.max:
                    raise TypeError(
                        f"{self.__name__}: firstprivate parameter {n!r} "
                        f"value {v} overflows the canonical integer "
                        f"dtype {np.dtype(info.dtype).name}; pass it as "
                        f"an explicit-width array instead")
            values.append(v)
        return tuple(values)

    def __call__(self, *args, **kwargs):
        rt = current_runtime()
        if rt is None:
            if any(isinstance(a, (Region, BlockArray))
                   for a in (*args, *kwargs.values())):
                raise RuntimeError(
                    f"{self.__name__}: called with block regions but no "
                    "active runtime scope — wrap the call in `with rt:` "
                    "(or `with rt.scope():`) to spawn it as a task")
            return self.fn(*args, **kwargs)      # eager / serial elision
        bound = self._sig.bind_partial(*args, **kwargs)
        extra = [n for n in bound.arguments
                 if n not in self.modes and n not in self.firstprivate]
        if extra:
            raise TypeError(
                f"{self.__name__}: parameters without a footprint or "
                f"firstprivate declaration are closure captures and "
                f"cannot be bound at a spawn site: {extra}")
        missing = [n for n in self.modes if n not in bound.arguments]
        if missing:
            raise TypeError(
                f"{self.__name__}: every footprint parameter needs a "
                f"region at the call site; missing {missing}")
        access = tuple(
            self.modes[name](as_region(bound.arguments[name], name))
            for name in self.modes)
        return rt._initiate(self.fn, access, name=self.__name__,
                            values=self._bind_values(bound))

    def spawn_on(self, rt, *args, **kwargs) -> TaskFuture:
        """Spawn explicitly on ``rt`` (no ambient scope needed)."""
        _push_runtime(rt)
        try:
            return self(*args, **kwargs)
        finally:
            _pop_runtime(rt)

    def __repr__(self):
        ann = ", ".join(f"{n}:{m.__name__}" for n, m in self.modes.items())
        if self.firstprivate:
            ann += ", " + ", ".join(f"{n}:firstprivate"
                                    for n in self.firstprivate)
        return f"<task {self.__name__}({ann})>"


def task(fn: Callable | None = None, *, in_=(), out=(), inout=(),
         firstprivate=(), footprint=None):
    """Declare a task function's footprint (OmpSs ``#pragma omp task``).

    ``in_`` / ``out`` / ``inout`` each name one parameter (a string) or
    several (an iterable).  Every parameter of the function must appear in
    exactly one list — or in ``firstprivate`` — or carry a default; at
    call sites inside a ``with rt:`` scope each footprint parameter
    receives a block :class:`Region` (or a whole :class:`BlockArray`).
    ``footprint`` is the mapping spelling of the same declaration — a
    dict of parameter name to access mode, where each mode is ``"in"``/
    ``"out"``/``"inout"`` or an :class:`AccessMode` member
    (``AccessMode.INOUT``); it merges with the list kwargs and a
    parameter declared through both raises the usual duplicate error::

        @task(footprint={"c": AccessMode.INOUT, "a": "in", "b": "in"})
        def gemm(c, a, b): ...
    The function body receives materialized arrays for its ``in_`` and
    ``inout`` parameters (in parameter order) and returns one array per
    ``out``/``inout`` parameter (in parameter order).

    ``firstprivate`` names parameters passed *by value* at the spawn site
    (scalars, index offsets, small arrays): the value is copied into the
    task descriptor at initiation, never synchronized on, and handed to
    the body positionally right after the ``in_``/``inout`` arrays.  A
    firstprivate parameter may declare a default, used when the spawn
    site omits it.  On the staged executor, same-function tasks of a
    wavefront that differ only in firstprivate values batch into one
    ``torch.func.vmap(fn)`` dispatch with the values stacked as vmap
    operands — so the body must batch over them (index with offset
    arithmetic and ``index_select``, not Python slicing or ``narrow``).
    """
    def wrap(f):
        fin, fout, finout = (list(_names(in_)), list(_names(out)),
                             list(_names(inout)))
        if footprint:
            buckets = {"in": fin, "out": fout, "inout": finout}
            for name, mode in footprint.items():
                buckets[coerce_mode(mode)].append(name)
        return TaskFn(f, in_=tuple(fin), out=tuple(fout),
                      inout=tuple(finout), firstprivate=firstprivate)
    if fn is not None:                 # bare @task is an error we explain
        raise TypeError(
            "@task needs footprint declarations, e.g. "
            "@task(inout='c', in_=('a', 'b'))")
    return wrap
