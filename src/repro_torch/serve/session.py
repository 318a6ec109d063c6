"""Continuous-ingestion serving on top of
:class:`~repro_torch.core.TaskRuntime` (the JAX package's
``serve/session.py``).

Batch programs build one graph and drain it; a serving loop never
drains.  Requests arrive as *small task graphs* spawned against shared
long-lived ``BlockArray`` state (embedding tables, KV tiles), each
resolving through its own :class:`~repro_torch.core.TaskFuture`s — the
dependence-cone waits and region-scoped ``wait_on`` the batch API
already has are exactly per-request isolation: requests touching
disjoint tiles never serialize behind each other.

::

    from repro_torch import RuntimeConfig
    from repro_torch.serve import ServeConfig, Session

    with Session(RuntimeConfig(executor="host", device="cuda"),
                 ServeConfig(budget_bytes=1 << 20)) as s:
        kv = s.from_array(kv_init, (1, 64, 64), name="kv")   # shared state
        out = s.zeros((n_slots, 64), (1, 64), name="out", state=False)
        h = s.submit(lambda: lookup(out[i], kv[j]), out[i], kv[j])
        h.wait()                       # this request's cone only
        print(h.latency_s, s.stats().admission_admitted)

``submit`` declares the request's block footprint up front; the
:class:`~repro_torch.serve.admission.AdmissionController` bounds the total
in-flight footprint bytes, queuing or shedding beyond the budget.  The
builder runs only on admission — a deferred request costs nothing until
capacity frees.

Fault tolerance lives at the memory layer: ``checkpoint()`` snapshots
every ``state=True`` array's tiles through ``repro_torch.ckpt.save_tiles``
(epoch-tagged, per-home files, async by default — off the serving
critical path), and ``restore_latest()`` reloads the newest committed
epoch bit-identically after a runtime restart.
"""
from __future__ import annotations

import contextlib
import time
from collections import deque
from typing import Callable, Sequence

from ..ckpt import latest_epoch, restore_tiles, save_tiles
from ..core.api import RuntimeConfig, RuntimeStats, TaskFuture
from ..core.blocks import BlockArray, Region
from ..core.runtime import TaskRuntime
from .admission import ADMIT, DEFER, AdmissionController, RequestRejected

__all__ = ["ServeConfig", "Session", "RequestHandle"]

_ON_SATURATION = ("queue", "reject")


def footprint_nbytes(regions: Sequence) -> int:
    """Total bytes of the distinct tiles the regions cover (a tile named
    by several regions counts once — the admission unit of one request)."""
    seen: set = set()
    nbytes = 0
    for r in regions:
        if isinstance(r, BlockArray):
            r = r.whole
        if not isinstance(r, Region):
            raise TypeError(f"expected a Region or BlockArray, "
                            f"got {type(r).__name__}")
        per_tile = r.array.tile_nbytes
        for b in r.block_ids:
            if b not in seen:
                seen.add(b)
                nbytes += per_tile
    return nbytes


class ServeConfig:
    """Serving knobs, validated once at session construction.

    * ``budget_bytes``    — in-flight footprint byte budget (admission).
    * ``on_saturation``   — ``"queue"`` (FIFO, admit as capacity frees)
      or ``"reject"`` (shed load beyond the budget).
    * ``max_home_depth``  — also defer while any worker ring holds more
      than this many in-flight tasks (0 = off); read from the live
      queue depths the scheduler/tracker maintain.
    * ``checkpoint_dir``  — where tile checkpoints go (None = no
      checkpointing).
    * ``checkpoint_every``— auto-checkpoint after this many completed
      requests (0 = manual ``checkpoint()`` calls only).
    * ``async_checkpoint``— commit checkpoint epochs on a writer thread,
      off the serving critical path.
    """

    def __init__(self, budget_bytes: int = 1 << 30, *,
                 on_saturation: str = "queue", max_home_depth: int = 0,
                 checkpoint_dir: str | None = None,
                 checkpoint_every: int = 0, async_checkpoint: bool = True):
        if budget_bytes < 1:
            raise ValueError("budget_bytes must be >= 1")
        if on_saturation not in _ON_SATURATION:
            raise ValueError(f"on_saturation must be one of "
                             f"{_ON_SATURATION}, got {on_saturation!r}")
        if max_home_depth < 0:
            raise ValueError("max_home_depth must be >= 0 (0 = off)")
        if checkpoint_every < 0:
            raise ValueError("checkpoint_every must be >= 0 (0 = manual)")
        if checkpoint_every and checkpoint_dir is None:
            raise ValueError("checkpoint_every needs a checkpoint_dir")
        self.budget_bytes = int(budget_bytes)
        self.on_saturation = on_saturation
        self.max_home_depth = int(max_home_depth)
        self.checkpoint_dir = checkpoint_dir
        self.checkpoint_every = int(checkpoint_every)
        self.async_checkpoint = bool(async_checkpoint)


class RequestHandle:
    """One submitted request: its state, futures, and latency."""

    QUEUED = "queued"
    ADMITTED = "admitted"
    REJECTED = "rejected"
    DONE = "done"

    def __init__(self, session: "Session", name: str, builder: Callable,
                 nbytes: int):
        self._session = session
        self.name = name
        self._builder = builder
        self.nbytes = nbytes
        self.state = self.QUEUED
        self.futures: tuple[TaskFuture, ...] = ()
        self.submit_ts = time.perf_counter()
        self.done_ts: float | None = None

    # -- introspection ------------------------------------------------------
    def done(self) -> bool:
        return self.state == self.DONE

    def rejected(self) -> bool:
        return self.state == self.REJECTED

    @property
    def latency_s(self) -> float | None:
        """Submit-to-completion wall time (None while in flight)."""
        if self.done_ts is None:
            return None
        return self.done_ts - self.submit_ts

    # -- synchronization ----------------------------------------------------
    def wait(self) -> "RequestHandle":
        """Block until this request completed — forces only its own
        tasks' dependence cones, never unrelated in-flight requests."""
        self._session._wait_handle(self)
        return self

    def result(self):
        """Wait, then return the request's task results (one per future,
        in builder order; a single-future request returns it bare)."""
        self.wait()
        results = [f.result() for f in self.futures]
        if not results:
            return None
        return results[0] if len(results) == 1 else results

    def __repr__(self):
        return f"<RequestHandle {self.name} {self.state} {self.nbytes}B>"


class Session:
    """A serving loop over one runtime: submit, admit, resolve, repeat.

    Single-threaded by design (like the paper's master core): ``submit``
    / ``poll`` / ``wait`` are called from the master thread, and the
    executor parallelizes underneath.  Use as a context manager — exit
    drains in-flight requests, resolves still-queued ones as rejected,
    writes a final checkpoint (when configured), and shuts down an
    internally-created runtime.
    """

    def __init__(self, config: RuntimeConfig | None = None,
                 serve: ServeConfig | None = None, *,
                 runtime: TaskRuntime | None = None, **overrides):
        self.serve = serve or ServeConfig()
        if runtime is not None:
            if config is not None or overrides:
                raise ValueError("pass either a ready runtime= or a "
                                 "RuntimeConfig, not both")
            self.rt = runtime
            self._rt_owned = False
        else:
            self.rt = TaskRuntime(config, **overrides)
            self._rt_owned = True
        if self.rt.executor_kind == "sim":
            raise ValueError("executor='sim' is timing-only and never "
                             "computes task values; serve needs a real "
                             "executor")
        obs = self.rt.obs
        depths_fn = self.rt.scheduler.queue_depths
        self.admission = AdmissionController(
            self.serve.budget_bytes, on_saturation=self.serve.on_saturation,
            max_home_depth=self.serve.max_home_depth,
            depths_fn=depths_fn, obs=obs)
        self.rt.admission = self.admission    # stats() surfaces admission_*
        self._state: dict[str, BlockArray] = {}
        self._queue: deque[RequestHandle] = deque()
        self._inflight: list[RequestHandle] = []
        self._req_counter = 0
        self._ckpt_epoch = 0
        self._ckpt_thread = None
        self._completed_since_ckpt = 0
        self._closed = False

    # -- shared state -------------------------------------------------------
    def _track_state(self, ba: BlockArray, name: str | None,
                     state: bool) -> BlockArray:
        if state:
            if name is None:
                raise ValueError("state arrays need an explicit name= "
                                 "(checkpoint identity across restarts)")
            if name in self._state:
                raise ValueError(f"state array {name!r} already registered")
            self._state[name] = ba
        return ba

    def from_array(self, arr, block_shape, name: str | None = None, *,
                   state: bool = True) -> BlockArray:
        """Register shared state (checkpointed under ``name``); pass
        ``state=False`` for per-request scratch arrays."""
        return self._track_state(
            self.rt.from_array(arr, block_shape, name), name, state)

    def zeros(self, shape, block_shape, dtype=None,
              name: str | None = None, *, state: bool = True) -> BlockArray:
        return self._track_state(
            self.rt.zeros(shape, block_shape, dtype, name), name, state)

    def full(self, shape, block_shape, fill, dtype=None,
             name: str | None = None, *, state: bool = True) -> BlockArray:
        return self._track_state(
            self.rt.full(shape, block_shape, fill, dtype, name), name, state)

    # -- request ingestion --------------------------------------------------
    def submit(self, builder: Callable, *footprint,
               name: str | None = None) -> RequestHandle:
        """Submit one request: ``builder`` spawns its task graph when the
        request is admitted (it runs inside the runtime scope and returns
        the request's TaskFuture(s)); ``footprint`` declares the block
        regions the graph will touch — the admission unit.

        Returns immediately with a :class:`RequestHandle` in state
        ``admitted`` (builder ran), ``queued`` (deferred until capacity
        frees) or ``rejected`` (budget shed / oversize).
        """
        if self._closed:
            raise RuntimeError("session is closed")
        if not footprint:
            raise ValueError("a request must declare a non-empty footprint "
                             "(the regions its task graph touches)")
        self._req_counter += 1
        rname = name or f"req-{self._req_counter}"
        handle = RequestHandle(self, rname, builder,
                               footprint_nbytes(footprint))
        decision = self.admission.try_admit(rname, handle.nbytes)
        if decision == ADMIT:
            self._launch(handle)
        elif decision == DEFER:
            self._queue.append(handle)
        else:
            handle.state = RequestHandle.REJECTED
        return handle

    def _launch(self, handle: RequestHandle) -> None:
        with self.rt.scope():
            futures = handle._builder()
        if futures is None:
            futures = ()
        elif isinstance(futures, TaskFuture):
            futures = (futures,)
        handle.futures = tuple(futures)
        handle._builder = None          # release the closure
        handle.state = RequestHandle.ADMITTED
        self._inflight.append(handle)

    # -- completion ---------------------------------------------------------
    def poll(self) -> int:
        """Complete every admitted request whose tasks all finished
        (non-blocking); returns how many completed.  Call between
        arrivals under an eager executor (the host executor exposes a
        non-blocking ``pump`` that polls the worker rings); with lazy
        executors completion is driven by ``wait()``/``drain()``."""
        pump = getattr(self.rt._exec, "pump", None)
        if pump is not None:
            pump()
        done = [h for h in self._inflight
                if all(f.descriptor.is_complete for f in h.futures)]
        for h in done:
            self._complete(h)
        return len(done)

    def _wait_handle(self, handle: RequestHandle) -> None:
        if handle.state == RequestHandle.REJECTED:
            raise RequestRejected(f"request {handle.name} was rejected "
                                  f"({handle.nbytes}B over budget or shed)")
        while handle.state == RequestHandle.QUEUED:
            # queued behind in-flight work: retire the oldest admitted
            # request to free capacity, then re-drain the queue
            if self._inflight:
                self._wait_handle(self._inflight[0])
            else:
                self._drain_queue()
                if not self._inflight and \
                        handle.state == RequestHandle.QUEUED:
                    self._force_admit_front()
        if handle.state == RequestHandle.DONE:
            return
        self.rt._wait_tasks([f.descriptor for f in handle.futures],
                            kind="request")
        self._complete(handle)

    def _complete(self, handle: RequestHandle) -> None:
        handle.done_ts = time.perf_counter()
        handle.state = RequestHandle.DONE
        self._inflight.remove(handle)
        self.admission.release(handle.name, handle.nbytes,
                               latency_s=handle.latency_s)
        self._completed_since_ckpt += 1
        self._drain_queue()
        if self.serve.checkpoint_every and \
                self._completed_since_ckpt >= self.serve.checkpoint_every:
            self.checkpoint()

    def _drain_queue(self) -> None:
        while self._queue and self.admission.has_room(self._queue[0].nbytes):
            handle = self._queue.popleft()
            self.admission.admit_deferred(handle.name, handle.nbytes)
            self._launch(handle)

    def _force_admit_front(self) -> None:
        # depth back-pressure deferred the queue front but nothing is
        # left in flight to wait for — push it through so waits always
        # make progress (the byte budget itself is never exceeded here:
        # with zero bytes in flight any non-oversize request fits)
        handle = self._queue.popleft()
        self.admission.admit_deferred(handle.name, handle.nbytes)
        self._launch(handle)

    def drain(self) -> None:
        """Resolve everything: admitted requests complete, queued ones
        admit as capacity frees."""
        self._drain_queue()
        while self._inflight or self._queue:
            if self._inflight:
                self._wait_handle(self._inflight[0])
                continue
            self._drain_queue()
            if not self._inflight and self._queue:
                self._force_admit_front()

    # -- checkpoint / restore ----------------------------------------------
    @property
    def state_bytes(self) -> int:
        return sum(int(ba.tile_nbytes) * len(ba.home)
                   for ba in self._state.values())

    def checkpoint(self, *, sync: bool | None = None) -> int:
        """Snapshot every state array's tiles as the next epoch (through
        ``repro_torch.ckpt.save_tiles``); returns the epoch number.  Async by
        default — the snapshot to host memory is synchronous, the disk
        commit happens on a writer thread."""
        if self.serve.checkpoint_dir is None:
            raise RuntimeError("no checkpoint_dir configured")
        if not self._state:
            raise RuntimeError("no state arrays registered")
        self._join_ckpt()
        self._ckpt_epoch += 1
        self._completed_since_ckpt = 0
        async_save = self.serve.async_checkpoint if sync is None \
            else not sync
        result = save_tiles(self.serve.checkpoint_dir, self._ckpt_epoch,
                            self._state, async_save=async_save)
        if async_save:
            self._ckpt_thread = result
        if self.rt.obs.enabled:
            self.rt.obs.emit(
                "ckpt_save", epoch=self._ckpt_epoch,
                arrays=len(self._state),
                tiles=sum(len(ba.home) for ba in self._state.values()),
                bytes=self.state_bytes)
        return self._ckpt_epoch

    def restore_latest(self) -> int | None:
        """Reload the newest committed epoch into the registered state
        arrays (bit-identical tiles); None when no checkpoint exists.
        Future checkpoints continue after the restored epoch."""
        if self.serve.checkpoint_dir is None:
            raise RuntimeError("no checkpoint_dir configured")
        if latest_epoch(self.serve.checkpoint_dir) is None:
            return None
        epoch, _ = restore_tiles(self.serve.checkpoint_dir, self._state)
        self._ckpt_epoch = epoch
        if self.rt.obs.enabled:
            self.rt.obs.emit(
                "ckpt_restore", epoch=epoch, arrays=len(self._state),
                tiles=sum(len(ba.home) for ba in self._state.values()),
                bytes=self.state_bytes)
        return epoch

    def _join_ckpt(self) -> None:
        if self._ckpt_thread is not None:
            self._ckpt_thread.join()
            self._ckpt_thread = None

    # -- lifecycle ----------------------------------------------------------
    def stats(self) -> RuntimeStats:
        """The runtime's stats with the ``admission_*`` fields filled."""
        return self.rt.stats()

    def close(self) -> None:
        """Drain admitted work, resolve still-queued requests as
        rejected when shedding (or admit them when queuing), commit the
        final checkpoint, and shut down an owned runtime."""
        if self._closed:
            return
        self.drain()
        self._closed = True
        if self.serve.checkpoint_dir is not None and self._state:
            with contextlib.suppress(RuntimeError):
                self.checkpoint()
            self._join_ckpt()
        if self._rt_owned:
            self.rt.barrier()
            self.rt.shutdown()

    def __enter__(self) -> "Session":
        return self

    def __exit__(self, *exc) -> None:
        if exc == (None, None, None):
            self.close()
        elif self._rt_owned:
            self.rt.shutdown()

    def __repr__(self):
        return (f"<Session {len(self._inflight)} in flight, "
                f"{len(self._queue)} queued, "
                f"{self.admission.in_flight_bytes}/"
                f"{self.serve.budget_bytes}B>")
