"""repro_torch's host executor against repro's, on the CPU.

The host executor is the paper's runtime: the spawning thread is the
master, worker threads drain their MPB rings.  Held against the JAX
package on the same programs and seeds:

* the five paper apps: every task's dependence set at spawn and
  ``deps_found`` equal to the reference host executor's, outputs within
  each app's own ``verify=`` tolerance;
* the pinned worker tile cache: a rewritten tile is read back fresh
  (freshness by tensor identity holds only because writes swap in new
  tensors), an unchanged one is a hit;
* a task body that raises on a worker surfaces on the master within a
  bounded time instead of hanging it;
* a stress run with more workers than cores keeps every dependence.

Every runtime here shuts its workers down, and every test ends in
seconds.
"""
import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

from benchmarks import apps as ref_apps
from repro import RuntimeConfig as RefConfig, TaskRuntime as RefRuntime
from repro_torch import RuntimeConfig, TaskRuntime, apps, task
from repro_torch.obs import InMemoryTracker

SIZES = {
    "black_scholes": dict(n_options=2048, task_options=256),
    "matmul": dict(n=64, tile=16),
    "fft": dict(n=64, row_block=16, tile=16),
    "jacobi": dict(n=64, tile=16, iters=2),
    "cholesky": dict(n=64, tile=16),
}
TOLERANCE = {
    "black_scholes": (1e-5, 1e-3),
    "matmul": (2e-4, 2e-4),
    "fft": (2e-2, 2e-1),
    "jacobi": (1e-5, 1e-5),
    "cholesky": (2e-2, 2e-2),
}


def _host(**kw):
    kw.setdefault("n_workers", 3)
    return TaskRuntime(RuntimeConfig(executor="host", device="cpu", **kw))


def _record(rt, program, sizes):
    spawns = []
    on_spawn = rt._exec.on_spawn

    def record_spawn(td, ready):
        spawns.append((td.tid, td.name, tuple(p.tid for p in td.preds),
                       ready))
        on_spawn(td, ready)

    rt._exec.on_spawn = record_spawn
    try:
        out = program(rt, **sizes)
        rt.barrier()
        stats = rt.stats()
    finally:
        rt.shutdown()
    outs = out if isinstance(out, tuple) else (out,)
    gathered = [a.gather() for a in outs]
    return spawns, stats, [np.asarray(g.cpu() if isinstance(g, torch.Tensor)
                                      else g) for g in gathered]


@pytest.mark.parametrize("name", sorted(SIZES))
def test_apps_on_host_match_the_reference_host_executor(name):
    ref = _record(RefRuntime(RefConfig(executor="host", n_workers=3)),
                  ref_apps.APPS[name], SIZES[name])
    port = _record(_host(), apps.APPS[name], SIZES[name])
    assert port[0] == ref[0]                     # dependence sets at spawn
    for fld in ("tasks_spawned", "deps_found", "blocks_walked"):
        assert getattr(port[1], fld) == getattr(ref[1], fld), fld
    assert sum(port[1].worker_tasks) == port[1].tasks_spawned
    assert len(port[1].worker_busy_s) == 3
    rtol, atol = TOLERANCE[name]
    for g, w in zip(port[2], ref[2]):
        if name == "cholesky":
            g, w = np.tril(g), np.tril(w)
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol)


# ---------------------------------------------------------------------------
@task(in_="a", out="c")
def _copy(a, c=None):
    return a * 1.0


@task(inout="x")
def _bump(x):
    return x + 1.0


def test_tile_cache_reads_a_rewritten_tile_fresh():
    with _host(n_workers=1, worker_cache_tiles=8) as rt:
        A = rt.full((8, 4), (4, 4), 1.0)
        C = rt.zeros((8, 4), (4, 4))
        assert _copy(A[0, 0], C[0, 0]).result()[0, 0].item() == 1.0  # miss
        assert _copy(A[0, 0], C[0, 0]).result()[0, 0].item() == 1.0  # hit
        old = A.get_tile((0, 0))
        _bump(A[0, 0])                             # reads A (a hit) ...
        rt.wait_on(A[0, 0])
        assert A.get_tile((0, 0)) is not old       # ... and swaps the tile
        assert old[0, 0].item() == 1.0             # nothing wrote in place
        assert _copy(A[0, 0], C[0, 0]).result()[0, 0].item() == 2.0  # miss
        A.set_tile((0, 0), torch.full((4, 4), 7.0))          # master write
        assert _copy(A[0, 0], C[0, 0]).result()[0, 0].item() == 7.0  # miss
        # a two-tile region: rewriting one of its tiles invalidates it
        R = rt.zeros((8, 4), (8, 4))
        assert _copy(A[0:2, 0], R[0, 0]).result().sum().item() == \
            16 * 7.0 + 16 * 1.0                                      # miss
        _bump(A[1, 0])
        assert _copy(A[0:2, 0], R[0, 0]).result().sum().item() == \
            16 * 7.0 + 16 * 2.0                                      # miss
        stats = rt.stats()
    assert stats.worker_cache_hits == [2]
    assert stats.worker_cache_misses == [6]


def test_tile_cache_off_counts_nothing_and_emits_its_events():
    trk = InMemoryTracker()
    with _host(n_workers=2, worker_cache_tiles=0, tracker=trk) as rt:
        A = rt.full((8, 4), (4, 4), 1.0)
        C = rt.zeros((8, 4), (4, 4))
        for _ in range(3):
            _copy(A[0, 0], C[0, 0])
    assert rt.stats().worker_cache_hits == [0, 0]
    assert [e.data["worker"] for e in trk.events_of("tile_cache")] == [0, 1]


@task(inout="x")
def _boom(x):
    raise ValueError("body failed on a worker")


@pytest.mark.parametrize("sync", ["barrier", "result", "pump"])
def test_failing_body_surfaces_on_the_master(sync):
    t0 = time.monotonic()
    rt = _host(n_workers=2)
    try:
        with rt.scope():
            X = rt.zeros((8, 4), (4, 4))
            fut = _boom(X[0, 0])
            _bump(X[1, 0])                        # an unrelated task
        with pytest.raises(ValueError, match="body failed"):
            if sync == "barrier":
                rt.barrier()
            elif sync == "result":
                fut.result()
            else:
                deadline = time.monotonic() + 20
                while time.monotonic() < deadline:
                    rt._exec.pump()
                    time.sleep(0.001)
        assert isinstance(fut.descriptor.error, ValueError)
        with pytest.raises(ValueError, match="body failed"):
            rt.barrier()                          # it stays raised
    finally:
        rt.shutdown()
    assert not any(w.is_alive() for w in rt._exec.workers)
    assert time.monotonic() - t0 < 30


def test_stress_more_workers_than_cores_keeps_every_dependence():
    """A chain of read-modify-write tasks on one tile, interleaved with
    independent tasks, over more worker threads than cores and a short
    switch interval: a lost or reordered update changes the sum."""
    n_workers = 2 * (os.cpu_count() or 4)
    chain = 300
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    t0 = time.monotonic()
    try:
        with _host(n_workers=n_workers, mpb_slots=2) as rt:
            X = rt.zeros((4 * n_workers, 4), (4, 4))
            for i in range(chain):
                _bump(X[0, 0])
                _bump(X[1 + i % (n_workers - 1), 0])
            rt.barrier()
            total = X.gather()
            stats = rt.stats()
    finally:
        sys.setswitchinterval(old)
    assert total[:4].eq(chain).all()
    assert total.sum().item() == 16 * 2 * chain
    assert sum(stats.worker_tasks) == 2 * chain
    assert threading.active_count() < n_workers       # all joined
    assert time.monotonic() - t0 < 60
