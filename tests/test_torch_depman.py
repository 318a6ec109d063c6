"""repro_torch's home-sharded dependence managers against repro's, on the CPU.

The port of ``tests/test_depman.py`` and ``tests/test_mpb_stress.py``:

* unit parity inside the port on constructed streams — the sharded
  manager finds the central analyzer's dependences (RAW/WAW/WAR chains,
  WAR with interleaved completion, no self-dependences, a cross-home
  predecessor counted once, ``blocks_walked``, ``tasks_touching``,
  route-cache invalidation, the grant-ring overflow tripwire);
* leak bounds, split-phase admission equal to blocking, ``dep_pump="auto"``
  from the environment, quiesce with admissions outstanding, tiny rings
  under both pumps, the MPB rings under real threads;
* across the packages: one footprint stream through ``repro``'s and the
  port's ``ShardedDependenceManager`` (batch lines 1 and 4, both pumps,
  1, 2 and 4 homes) gives the same dependence sets, ``deps_found``,
  ``blocks_walked``, wire counts and admissions, and the port's
  ``traffic_log`` reconciles through ``repro.core.sim.predict_dep_traffic``
  and through the port's own ``repro_torch.core.sim.predict_dep_traffic``;
* the five apps: identical staged wave schedules under central,
  sharded-sync and sharded-threaded, equal to the reference's, and equal
  outputs of the sequential, host and staged executors under either
  manager.
"""
import random
import sys
import threading
import time
from collections import deque
from types import SimpleNamespace

import pytest
import torch

import repro
from benchmarks import apps as ref_apps
from repro.core import depman as ref_depman
from repro.core import executor as ref_executor
from repro.core import graph as ref_graph
from repro.core import placement as ref_placement
from repro.core.deps import DependenceAnalyzer as RefAnalyzer
from repro.core.sim import predict_dep_traffic
import repro_torch
from repro_torch import (In, InOut, Out, RuntimeConfig, ShardedDependenceManager,
                         TaskRuntime, apps, task)
from repro_torch.core import depman, executor, graph, placement
from repro_torch.core import sim as port_sim
from repro_torch.core.deps import DependenceAnalyzer
from repro_torch.core.depman import DepMessage
from repro_torch.core.graph import DescriptorPool, TaskGraph
from repro_torch.core.mpb import MPBChannel, MPBQueue, SlotState
from repro_torch.core.placement import assign_homes
from repro_torch.obs import InMemoryTracker

PORT = SimpleNamespace(
    Manager=depman.ShardedDependenceManager,
    Pool=graph.DescriptorPool, Graph=graph.TaskGraph,
    In=repro_torch.In, Out=repro_torch.Out, InOut=repro_torch.InOut,
    zeros=lambda shape, block: repro_torch.BlockArray.zeros(
        shape, block, device="cpu"),
    assign_homes=placement.assign_homes)
REF = SimpleNamespace(
    Manager=ref_depman.ShardedDependenceManager,
    Pool=ref_graph.DescriptorPool, Graph=ref_graph.TaskGraph,
    In=repro.In, Out=repro.Out, InOut=repro.InOut,
    zeros=lambda shape, block: repro.BlockArray.zeros(shape, block),
    assign_homes=ref_placement.assign_homes)


def _noop(*_a, **_k):
    return None


def _array(ns, grid: int, homes: int, seg: int = 4):
    """A ``grid x seg`` grid of 1-element tiles, each block row behind one
    home (``benchmarks/spawn_throughput.build_array``'s layout)."""
    ba = ns.zeros((grid, seg), (1, 1))
    ns.assign_homes(ba, "striped_rows", homes)
    return ba


def _grid(homes=4):
    return _array(PORT, 8, homes)


def _sharded(ba, n=4):
    mgr = ShardedDependenceManager(n_managers=n)
    mgr.register_array(ba)
    return mgr


def _retire(ns_graph, analyzer, pool, live: deque) -> None:
    td = live.popleft()
    ns_graph.mark_executed(td)
    ns_graph.release(td)
    analyzer.forget_completed(td)
    pool.release(td)


def run_stream(ns, n_tasks: int, analyzer, ba, window: int = 64,
               chunk: int = 32, footprints=None) -> dict:
    """``benchmarks/spawn_throughput.run_stream`` for either package: push
    ``n_tasks`` tasks through one analyzer in chunks (split-phase where
    the analyzer has it), retire the live window down after each chunk.
    ``footprints(t, ba)`` gives task ``t``'s arguments (default: the
    three-row stencil).  Returns the counters, the dependence checksum
    and every task's dependence set as spawn orders."""
    grid, seg = ba.grid
    if footprints is None:
        def footprints(t, ba):
            i = t % grid
            return (ns.InOut(ba[i, 0:seg]), ns.In(ba[(i + 1) % grid, 0:seg]),
                    ns.In(ba[(i - 1) % grid, 0:seg]))
    chunk = max(1, min(chunk, window // 2))
    split = hasattr(analyzer, "analyze_begin")
    pool = ns.Pool(capacity=window * 2)
    tg = ns.Graph()
    live: deque = deque()
    csum = 0
    deps_log = []
    t = 0
    while t < n_tasks:
        n = min(chunk, n_tasks - t)
        tds = []
        for k in range(n):
            td = pool.acquire(_noop, footprints(t + k, ba))
            td.spawn_order = t + k
            if split:
                analyzer.analyze_begin(td)
            tds.append(td)
        pairs = analyzer.admit_finish() if split else \
            [(td, analyzer.analyze(td)) for td in tds]
        for td, deps in pairs:
            tg.insert(td, deps)
            live.append(td)
            deps_log.append(sorted(d.spawn_order for d in deps))
            acc = len(deps) + sum(d.tid for d in deps)
            csum = (csum * 1000003 + acc) % (1 << 61)
        while len(live) >= window:
            _retire(tg, analyzer, pool, live)
        t += n
    while live:
        _retire(tg, analyzer, pool, live)
    return {"deps_found": analyzer.deps_found,
            "blocks_walked": analyzer.blocks_walked,
            "dep_checksum": csum, "deps": deps_log,
            "live_blocks": getattr(analyzer, "live_blocks",
                                   len(getattr(analyzer, "_meta", ())))}


class _Stream:
    """One footprint script through one analyzer: ``spawn`` analyzes and
    inserts, ``done`` completes and forgets (the runtime's lifecycle),
    recording each task's dependence tids."""

    def __init__(self, analyzer):
        self.analyzer = analyzer
        self.pool = DescriptorPool(capacity=256)
        self.graph = TaskGraph()
        self.tds: dict[str, object] = {}
        self.deps: dict[str, list[int]] = {}

    def spawn(self, name, *args):
        td = self.pool.acquire(_noop, tuple(args))
        td.spawn_order = len(self.tds)
        found = self.analyzer.analyze(td)
        self.graph.insert(td, found)
        self.tds[name] = td
        self.deps[name] = sorted(d.tid for d in found)
        return td

    def done(self, name):
        td = self.tds[name]
        self.graph.mark_executed(td)
        self.graph.release(td)
        self.analyzer.forget_completed(td)


def _both(script, n=4):
    """Run ``script`` through the port's central analyzer and its sharded
    manager; the recorded dependence tids must match task for task."""
    runs = []
    for analyzer, ba in ((DependenceAnalyzer(), _grid(n)),
                         (None, _grid(n))):
        s = _Stream(analyzer or _sharded(ba, n))
        script(s, ba)
        runs.append(s)
    central, sharded = runs
    assert central.deps == sharded.deps
    return central, sharded


# ---------------------------------------------------------------------------
# the MPB channel (the managers' transport)
class TestMPBChannel:
    def test_fifo_and_len(self):
        ch = MPBChannel("t", n_slots=4)
        for i in range(3):
            assert ch.try_send(i)
        assert len(ch) == 3
        assert ch.recv_all() == [0, 1, 2]
        assert len(ch) == 0

    def test_backpressure_counts_stalls(self):
        ch = MPBChannel("t", n_slots=2)
        assert ch.try_send("a") and ch.try_send("b")
        assert not ch.try_send("c")            # ring full
        assert ch.full_stalls == 1
        assert ch.sends == 2
        assert ch.recv_all() == ["a", "b"]
        assert ch.try_send("c")

    def test_recv_all_drains_once(self):
        ch = MPBChannel("t")
        ch.try_send(1)
        assert ch.recv_all() == [1]
        assert ch.recv_all() == []


# ---------------------------------------------------------------------------
# unit parity inside the port: sharded finds the central analyzer's deps
class TestShardedParity:
    def test_raw_waw_war_chain(self):
        def script(s, ba):
            s.spawn("w1", InOut(ba[0, 0:4]))
            s.spawn("r1", In(ba[0, 0:4]), InOut(ba[1, 0:4]))
            s.spawn("w2", InOut(ba[0, 0:4]))     # WAW on w1 + WAR on r1
            assert s.deps["r1"] == [s.tds["w1"].tid]
            assert sorted(s.deps["w2"]) == sorted(
                [s.tds["w1"].tid, s.tds["r1"].tid])

        _both(script)

    def test_war_with_interleaved_reader_completion(self):
        """A reader completed and forgotten before the writer arrives
        gives no WAR edge; one completed but not yet forgotten is
        filtered by liveness — both orderings match central."""
        def script(s, ba):
            s.spawn("r1", In(ba[0, 0:4]), InOut(ba[1, 0:4]))
            s.spawn("r2", In(ba[0, 0:4]), InOut(ba[2, 0:4]))
            s.done("r1")
            s.graph.mark_executed(s.tds["r2"])   # completed, NOT forgotten
            s.spawn("w", InOut(ba[0, 0:4]))
            assert s.deps["w"] == []

        _both(script)

    def test_war_orders_live_readers(self):
        def script(s, ba):
            s.spawn("r1", In(ba[0, 0:4]), InOut(ba[1, 0:4]))
            s.spawn("r2", In(ba[0, 0:4]), InOut(ba[2, 0:4]))
            s.done("r1")
            s.spawn("w", InOut(ba[0, 0:4]))
            assert s.deps["w"] == [s.tds["r2"].tid]

        _both(script)

    def test_same_block_two_modes_no_self_dep(self):
        def script(s, ba):
            s.spawn("t", Out(ba[0, 0:4]), In(ba[0, 0:4]))
            assert s.deps["t"] == []
            s.spawn("r", In(ba[0, 0:4]), InOut(ba[1, 0:4]))
            assert s.deps["r"] == [s.tds["t"].tid]

        _both(script)

    def test_cross_home_predecessor_counts_once(self):
        def script(s, ba):
            s.spawn("w", Out(ba[0:2, 0]))        # rows 0+1: homes 0 and 1
            s.spawn("r", In(ba[0:2, 0]), Out(ba[2, 0]))
            assert s.deps["r"] == [s.tds["w"].tid]

        central, sharded = _both(script)
        assert central.analyzer.deps_found == sharded.analyzer.deps_found \
            == 1

    def test_blocks_walked_matches_central(self):
        def script(s, ba):
            s.spawn("a", InOut(ba[0, 0:4]), In(ba[1, 0:4]))
            s.spawn("b", In(ba[0, 0:4]), Out(ba[3, 0:4]))
            s.done("a")

        central, sharded = _both(script)
        assert central.analyzer.blocks_walked \
            == sharded.analyzer.blocks_walked == 16

    @pytest.mark.parametrize("n", [1, 4])
    def test_tasks_touching_modes(self, n):
        ba = _grid(n)
        mgr = _sharded(ba, n)
        s = _Stream(mgr)
        w = s.spawn("w", InOut(ba[0, 0:4]))
        r = s.spawn("r", In(ba[1, 0:4]), Out(ba[2, 0:4]))
        blocks = list(ba[0:2, 0:4].block_ids)
        assert mgr.tasks_touching(blocks, "in") == {w}
        assert mgr.tasks_touching(blocks, "out") == {w, r}
        assert mgr.tasks_touching(blocks, "inout") == {w, r}
        s.done("w")
        assert mgr.tasks_touching(blocks, "in") == set()
        with pytest.raises(ValueError):
            mgr.tasks_touching(blocks, "rw")

    def test_route_cache_invalidated_on_register(self):
        ba = _grid(4)
        mgr = _sharded(ba, 4)
        s = _Stream(mgr)
        td = s.spawn("w", Out(ba[1, 0:4]))
        assert mgr.owner_of(td) == 1             # row-banded: row 1 home 1
        assign_homes(ba, "single", 4)            # re-place: all home 0
        mgr.register_array(ba)                   # clears the route cache
        td2 = s.spawn("w2", Out(ba[1, 0:4]))
        assert mgr.owner_of(td2) == 0

    def test_grant_ring_overflow_raises(self):
        ba = _grid(2)
        mgr = _sharded(ba, 2)
        td = DescriptorPool(capacity=4).acquire(_noop, (Out(ba[0, 0:4]),))
        td.spawn_order = 0
        # a stuffed grant ring must fail loudly, never drop a dependence
        # set; the query envelope goes in directly, since _flush_home
        # would drain the ring first (the invariant under test)
        while mgr.grants[0].try_send(DepMessage("dep_grant", 0, td, [])):
            pass
        env = DepMessage("dep_batch", 0, None,
                         [("dep_query", td,
                           [(False, True, list(ba[0, 0:4].block_ids))])])
        assert mgr.inbox[0].try_send(env)
        with pytest.raises(RuntimeError, match="overflow"):
            mgr._service(0)


# ---------------------------------------------------------------------------
# leak bounds: block metadata of retired tasks is dropped on both managers
class TestForgetReclaims:
    def test_streaming_live_blocks_return_to_zero(self):
        ba = _array(PORT, 16, 4)
        for analyzer in (DependenceAnalyzer(), _sharded(ba, 4)):
            r = run_stream(PORT, 2000, analyzer, ba)
            assert r["live_blocks"] == 0
        assert len(analyzer._live_parts) == 0    # sharded: slices freed

    def test_central_meta_stays_bounded(self):
        ba = _array(PORT, 16, 1)
        analyzer = DependenceAnalyzer()
        run_stream(PORT, 1000, analyzer, ba, window=32)
        assert len(analyzer._meta) == 0


# ---------------------------------------------------------------------------
# batching and the two pumps inside the port
def _run(pump, batch_lines, n=2000, homes=4, **kw):
    ba = _array(PORT, 16, homes)
    mgr = ShardedDependenceManager(n_managers=homes, batch_lines=batch_lines,
                                   pump=pump, pump_threads=2, **kw)
    mgr.register_array(ba)
    try:
        r = run_stream(PORT, n, mgr, ba)
    finally:
        mgr.shutdown()
    return mgr, r


class TestBatchingAndPumps:
    def test_batching_packs_envelopes(self):
        mgr1, _ = _run("sync", 1)
        mgr4, _ = _run("sync", 4)
        assert mgr4.dep_messages == mgr1.dep_messages
        assert mgr1.dep_batches == mgr1.dep_messages
        assert mgr4.dep_batches < mgr4.dep_messages
        assert mgr4.dep_lines < mgr1.dep_lines

    @pytest.mark.parametrize("batch_lines", [1, 4])
    def test_wire_counts_pump_invariant(self, batch_lines):
        sync_mgr, sync_r = _run("sync", batch_lines)
        thr_mgr, thr_r = _run("threaded", batch_lines)
        assert thr_r["dep_checksum"] == sync_r["dep_checksum"]
        assert thr_r["deps_found"] == sync_r["deps_found"]
        for fld in ("dep_messages", "dep_batches", "dep_lines"):
            assert getattr(thr_mgr, fld) == getattr(sync_mgr, fld), fld
        assert thr_mgr.admissions == sync_mgr.admissions

    @pytest.mark.parametrize("pump", ["sync", "threaded"])
    def test_tiny_rings_backpressure(self, pump):
        """channel_slots=2 puts every post under ring pressure; the
        stream still gives the roomy default's dependences and wire
        counts."""
        ref_mgr, ref = _run("sync", 4)
        mgr, r = _run(pump, 4, channel_slots=2)
        assert r["dep_checksum"] == ref["dep_checksum"]
        assert mgr.dep_messages == ref_mgr.dep_messages
        assert mgr.dep_batches == ref_mgr.dep_batches
        assert mgr.dep_lines == ref_mgr.dep_lines

    def test_quiesce_with_admissions_outstanding_raises(self):
        ba = _grid(2)
        mgr = _sharded(ba, 2)
        td = DescriptorPool(capacity=4).acquire(_noop, (Out(ba[0, 0:4]),))
        td.spawn_order = 0
        mgr.analyze_begin(td)
        with pytest.raises(RuntimeError, match="outstanding"):
            mgr.quiesce()
        assert len(mgr.admit_finish()) == 1
        mgr.quiesce()

    def test_threaded_pump_wall_accumulates(self):
        mgr, _ = _run("threaded", 4)
        assert mgr.pump_wall_s > 0.0
        assert sum(mgr.admissions) >= 2000
        assert len(mgr.idle_waits) == 2
        assert not any(t.is_alive() for t in mgr._threads)

    def test_split_phase_matches_blocking(self):
        ba = _grid(4)
        blocking = _Stream(_sharded(ba, 4))
        split_mgr = _sharded(ba, 4)
        pool = DescriptorPool(capacity=256)
        tds = []
        for t in range(12):
            args = (InOut(ba[t % 8, 0:4]), In(ba[(t + 1) % 8, 0:4]))
            blocking.spawn(f"t{t}", *args)
            td = pool.acquire(_noop, args)
            td.spawn_order = t
            split_mgr.analyze_begin(td)
            tds.append(td)
        pairs = split_mgr.admit_finish()
        assert [td for td, _ in pairs] == tds    # spawn order
        assert [sorted(d.tid for d in deps) for _, deps in pairs] == \
            [blocking.deps[f"t{t}"] for t in range(12)]

    def test_pump_error_reraises_on_the_master(self):
        """A pump thread that fails hands its exception to the master,
        which raises at its next wait instead of hanging."""
        ba = _grid(2)
        mgr = ShardedDependenceManager(n_managers=2, pump="threaded")
        mgr.register_array(ba)

        class Faulty(depman.HomeManager):
            __slots__ = ()

            def admit(self, task, items):
                raise ValueError("manager fault")

        mgr.managers[0] = Faulty(0)
        td = DescriptorPool(capacity=4).acquire(_noop, (Out(ba[0, 0:4]),))
        td.spawn_order = 0
        with pytest.raises(RuntimeError, match="pump thread failed"):
            mgr.analyze(td)
        mgr._stop.set()
        for t in mgr._threads:
            t.wake.set()
            t.join(timeout=5.0)
        assert not any(t.is_alive() for t in mgr._threads)

    def test_stress_many_pump_threads_short_switch_interval(self):
        """More pump threads than cores, the interpreter switching
        threads every microsecond: the threaded pump still gives the sync
        pump's dependence stream and wire counts."""
        ref_mgr, ref = _run("sync", 4, n=1500, homes=16)
        old = sys.getswitchinterval()
        sys.setswitchinterval(1e-6)
        try:
            ba = _array(PORT, 16, 16)
            mgr = ShardedDependenceManager(n_managers=16, batch_lines=4,
                                           pump="threaded", channel_slots=4)
            mgr.register_array(ba)
            try:
                r = run_stream(PORT, 1500, mgr, ba)
            finally:
                mgr.shutdown()
        finally:
            sys.setswitchinterval(old)
        assert len(mgr._threads) == 16
        assert not any(t.is_alive() for t in mgr._threads)
        assert r["deps"] == ref["deps"]
        for fld in ("dep_messages", "dep_batches", "dep_lines"):
            assert getattr(mgr, fld) == getattr(ref_mgr, fld), fld


# ---------------------------------------------------------------------------
# across the packages: one stream, two implementations, equal counts
def _mixed_footprints(ns, seed: int):
    """A seeded footprint stream over a 16x4 block grid: In/Out/InOut,
    single blocks, row strips and multi-row regions that span homes."""
    rng = random.Random(seed)
    kinds = [ns.In, ns.Out, ns.InOut]
    plan = []
    for _ in range(600):
        args = []
        for _ in range(rng.randint(1, 3)):
            r0 = rng.randrange(16)
            r1 = min(16, r0 + rng.choice((1, 1, 2, 3)))
            c0 = rng.randrange(4)
            c1 = min(4, c0 + rng.randint(1, 4))
            args.append((rng.randrange(3), r0, r1, c0, c1))
        plan.append(args)

    def footprints(t, ba):
        return tuple(kinds[k](ba[r0:r1, c0:c1])
                     for k, r0, r1, c0, c1 in plan[t])
    return footprints


def _cross(ns, homes, batch_lines, pump, stream):
    ba = _array(ns, 16, homes)
    mgr = ns.Manager(n_managers=homes, batch_lines=batch_lines, pump=pump,
                     pump_threads=2, channel_slots=8, record_traffic=True)
    mgr.register_array(ba)
    try:
        foot = None if stream == "stencil" else _mixed_footprints(ns, 7)
        r = run_stream(ns, 600, mgr, ba, window=48, chunk=16,
                       footprints=foot)
    finally:
        mgr.shutdown()
    r.update(dep_messages=mgr.dep_messages, dep_batches=mgr.dep_batches,
             dep_lines=mgr.dep_lines, admissions=list(mgr.admissions))
    return mgr, r


@pytest.mark.parametrize("stream", ["stencil", "mixed"])
@pytest.mark.parametrize("pump", ["sync", "threaded"])
@pytest.mark.parametrize("batch_lines", [1, 4])
@pytest.mark.parametrize("homes", [1, 2, 4])
def test_manager_counts_match_reference(homes, batch_lines, pump, stream):
    port_mgr, port = _cross(PORT, homes, batch_lines, pump, stream)
    _, ref = _cross(REF, homes, batch_lines, pump, stream)
    assert port["deps"] == ref["deps"]
    for fld in ("deps_found", "blocks_walked", "dep_messages",
                "dep_batches", "dep_lines", "admissions", "live_blocks"):
        assert port[fld] == ref[fld], fld
    assert port["deps_found"] > 0
    # the port's recorded logical stream, replayed through the
    # reference's flush-policy model and through the port's own copy of
    # it, predicts the port's wire counts
    pred = predict_dep_traffic(port_mgr.traffic_log, batch_lines,
                               port_mgr.traffic_deps)
    assert pred["dep_batches"] == port_mgr.dep_batches
    assert pred["dep_lines"] == port_mgr.dep_lines
    assert port_sim.predict_dep_traffic(port_mgr.traffic_log, batch_lines,
                                        port_mgr.traffic_deps) == pred


def test_central_analyzers_match_on_the_mixed_stream():
    """The stream the cross-package test drives is the central
    analyzer's too: both packages' DependenceAnalyzer and the port's
    sharded manager find the same sets."""
    runs = {}
    for name, ns, analyzer in (("port", PORT, DependenceAnalyzer()),
                               ("ref", REF, RefAnalyzer())):
        ba = _array(ns, 16, 4)
        runs[name] = run_stream(ns, 600, analyzer, ba, window=48, chunk=16,
                                footprints=_mixed_footprints(ns, 7))
    _, sharded = _cross(PORT, 4, 4, "sync", "mixed")
    assert runs["port"]["deps"] == runs["ref"]["deps"] == sharded["deps"]
    assert runs["port"]["deps_found"] == sharded["deps_found"]


# ---------------------------------------------------------------------------
# runtime integration
def _bump_program(rt, reps=3):
    @task(inout="x")
    def bump(x):
        return x + 1.0

    with rt.scope():
        A = rt.zeros((8, 8), (4, 4))
        for _ in range(reps):
            bump(A[0, 0])
            bump(A[1, 1])
        rt.barrier()
    return A


class TestRuntimeIntegration:
    def test_sharded_stats_carry_manager_counters(self):
        with TaskRuntime(RuntimeConfig(executor="staged", device="cpu",
                                       dep_manager="sharded")) as rt:
            A = _bump_program(rt)
            s = rt.stats()
        assert s.dep_messages > 0
        assert sum(s.manager_admissions) == s.tasks_spawned == 6
        torch.testing.assert_close(A.gather()[:4, :4],
                                   torch.full((4, 4), 3.0))

    def test_central_stats_leave_manager_fields_none(self):
        with TaskRuntime(RuntimeConfig(executor="staged",
                                       device="cpu")) as rt:
            _bump_program(rt, reps=1)
            s = rt.stats()
        for fld in ("dep_messages", "dep_batches", "dep_lines",
                    "pump_wall_s", "manager_admissions"):
            assert getattr(s, fld) is None, fld
        assert rt.dep_pump is None

    def test_manager_events_emitted_when_tracked(self):
        trk = InMemoryTracker()
        with TaskRuntime(RuntimeConfig(executor="staged", device="cpu",
                                       dep_manager="sharded",
                                       dep_batch_lines=4,
                                       tracker=trk)) as rt:
            _bump_program(rt, reps=1)
        assert len(trk.events_of("manager_admit")) == 2
        assert {e.data["msg"] for e in trk.events_of("dep_msg")} >= \
            {"dep_query", "dep_grant", "release"}
        batches = trk.events_of("dep_batch")
        assert {e.data["direction"] for e in batches} == {"post", "grant"}
        assert all(e.data["lines"] >= 1 for e in batches)

    def test_stats_carry_wire_counters(self):
        with TaskRuntime(RuntimeConfig(executor="staged", device="cpu",
                                       dep_manager="sharded",
                                       dep_pump="threaded",
                                       dep_batch_lines=4)) as rt:
            _bump_program(rt, reps=4)
            s = rt.stats()
        assert 0 < s.dep_batches <= s.dep_messages
        assert s.dep_lines > 0
        assert s.pump_wall_s >= 0.0
        assert not any(t.is_alive() for t in rt.analyzer._threads)

    def test_dep_pump_auto_resolves_from_env(self, monkeypatch):
        monkeypatch.setenv("REPRO_DEPMAN_THREADS", "2")
        with TaskRuntime(RuntimeConfig(executor="staged", device="cpu",
                                       dep_manager="sharded")) as rt:
            assert rt.dep_pump == "threaded"
            assert len(rt.analyzer._threads) == 2
        monkeypatch.setenv("REPRO_DEPMAN_THREADS", "not a number")
        with TaskRuntime(RuntimeConfig(executor="staged", device="cpu",
                                       dep_manager="sharded")) as rt:
            assert rt.dep_pump == "sync"
        monkeypatch.delenv("REPRO_DEPMAN_THREADS")
        with TaskRuntime(RuntimeConfig(executor="staged", device="cpu",
                                       dep_manager="sharded")) as rt:
            assert rt.dep_pump == "sync"

    @pytest.mark.parametrize("pump", ["sync", "threaded"])
    def test_wait_on_and_futures_under_sharded(self, pump):
        @task(inout="c", in_="a", firstprivate="s")
        def axpy(c, a, s):
            return c + s * a

        with TaskRuntime(RuntimeConfig(executor="host", device="cpu",
                                       n_workers=2, dep_manager="sharded",
                                       dep_pump=pump)) as rt:
            A = rt.full((8, 8), (4, 4), 1.0)
            C = rt.zeros((8, 8), (4, 4))
            for k in range(4):
                fut = axpy(C[k // 2, k % 2], A[k % 2, k // 2], float(k))
            rt.wait_on(C[0, 0])
            assert torch.equal(C.get_tile((0, 0)), torch.zeros(4, 4))
            assert torch.equal(fut.result(), torch.full((4, 4), 3.0))
            rt.barrier()
            assert rt.analyzer.live_blocks == 0


@pytest.mark.parametrize("execu", ["sequential", "host", "staged"])
@pytest.mark.parametrize("pump", ["sync", "threaded"])
def test_gather_matches_central(execu, pump):
    @task(inout="c", in_=("a", "b"))
    def gemm(c, a, b):
        return c + a @ b

    outs = []
    for dm in ("central", "sharded"):
        with TaskRuntime(RuntimeConfig(executor=execu, n_workers=2,
                                       device="cpu", dep_manager=dm,
                                       dep_pump=pump)) as rt:
            A = rt.full((8, 8), (4, 4), 2.0)
            B = rt.full((8, 8), (4, 4), 3.0)
            C = rt.zeros((8, 8), (4, 4))
            for i in range(2):
                for j in range(2):
                    for k in range(2):
                        gemm(C[i, j], A[i, k], B[k, j])
            rt.barrier()
            outs.append(C.gather())
    assert torch.equal(outs[0], outs[1])
    assert torch.equal(outs[0], torch.full((8, 8), 48.0))


# ---------------------------------------------------------------------------
# the five apps: identical wave schedules, and equal to the reference's
SIZES = {
    "black_scholes": {"n_options": 2048, "task_options": 256},
    "matmul": {"n": 128, "tile": 32},
    "fft": {"n": 64, "row_block": 16, "tile": 16},
    "jacobi": {"n": 128, "tile": 32, "iters": 2},
    "cholesky": {"n": 128, "tile": 32},
}
MANAGERS = {"central": {},
            "sharded-sync": {"dep_manager": "sharded", "dep_pump": "sync",
                             "dep_batch_lines": 4},
            "sharded-threaded": {"dep_manager": "sharded",
                                 "dep_pump": "threaded",
                                 "dep_batch_lines": 4}}


def _schedule(monkeypatch, cls, run_app, app, **cfg):
    """The staged wave schedule of one app run: the spawn orders of each
    wave's tasks (task ids recycle, spawn orders do not)."""
    orig = cls._wavefronts
    log: list = []

    def spy(self, tasks):
        waves = orig(self, tasks)
        log.append([tuple(t.spawn_order for t in w) for w in waves])
        return waves

    monkeypatch.setattr(cls, "_wavefronts", spy)
    stats = run_app(app, "staged", app_kwargs=SIZES[app], **cfg)
    monkeypatch.setattr(cls, "_wavefronts", orig)
    return log, stats


@pytest.mark.parametrize("app", sorted(SIZES))
def test_identical_wave_schedule_on_apps(app, monkeypatch):
    port, ref = {}, {}
    for name, cfg in MANAGERS.items():
        port[name] = _schedule(monkeypatch, executor.StagedExecutor,
                               apps.run_app, app, device="cpu", **cfg)
    for name in MANAGERS:
        ref[name] = _schedule(monkeypatch, ref_executor.StagedExecutor,
                              ref_apps.run_app, app, **MANAGERS[name])
    assert any(port["central"][0])               # the spy saw real waves
    for name, (log, stats) in port.items():
        assert log == port["central"][0], name
        assert log == ref["central"][0], name
        for fld in ("deps_found", "blocks_walked", "waves",
                    "grouped_dispatches"):
            assert getattr(stats, fld) == \
                getattr(port["central"][1], fld), (name, fld)
    for name in ("sharded-sync", "sharded-threaded"):
        assert ref[name][0] == ref["central"][0], name
        for fld in ("dep_messages", "dep_batches", "dep_lines",
                    "manager_admissions"):
            assert getattr(port[name][1], fld) == \
                getattr(ref[name][1], fld), (name, fld)


# ---------------------------------------------------------------------------
# the MPB transports under real threads (tests/test_mpb_stress.py)
N_MSGS = 10_000


def _napper(seed: int, every: int = 397):
    rng = random.Random(seed)
    calls = [0]

    def nap():
        calls[0] += 1
        if calls[0] % every == 0:
            time.sleep(rng.random() * 1e-3)

    return nap


class TestMPBStress:
    def test_spsc_no_loss_no_dup_fifo(self):
        ch = MPBChannel("stress", n_slots=8)
        got: list[int] = []
        done = threading.Event()
        errors: list[BaseException] = []

        def consumer():
            try:
                nap = _napper(1)
                while not (done.is_set() and not len(ch)):
                    got.extend(ch.recv_all())
                    nap()
            except BaseException as e:          # pragma: no cover
                errors.append(e)

        t = threading.Thread(target=consumer)
        t.start()
        nap = _napper(2)
        for i in range(N_MSGS):
            while not ch.try_send(i):
                time.sleep(0)
            nap()
        done.set()
        t.join(timeout=30)
        assert not t.is_alive()
        assert not errors
        assert got == list(range(N_MSGS))
        assert ch.sends == N_MSGS
        assert len(ch) == 0

    def test_echo_round_trip(self):
        inbox = MPBChannel("inbox", n_slots=4)
        grants = MPBChannel("grants", n_slots=4)
        stop = threading.Event()
        errors: list[BaseException] = []

        def pump():
            try:
                nap = _napper(3)
                while not (stop.is_set() and not len(inbox)):
                    for msg in inbox.recv_all():
                        while not grants.try_send(msg * 2):
                            time.sleep(0)
                    nap()
            except BaseException as e:          # pragma: no cover
                errors.append(e)

        t = threading.Thread(target=pump)
        t.start()
        answers: list[int] = []
        nap = _napper(4)
        n = N_MSGS // 4
        for i in range(n):
            while not inbox.try_send(i):
                answers.extend(grants.recv_all())
                time.sleep(0)
            answers.extend(grants.recv_all())
            nap()
        stop.set()
        t.join(timeout=30)
        assert not t.is_alive()
        while len(grants):
            answers.extend(grants.recv_all())
        assert not errors
        assert answers == [2 * i for i in range(n)]

    def test_master_worker_transitions(self):
        class _FakeTD:
            __slots__ = ("tid", "worker")

            def __init__(self, tid):
                self.tid = tid
                self.worker = None

        q = MPBQueue(worker_id=0, n_slots=8)
        done = threading.Event()
        errors: list[BaseException] = []
        ran: list[int] = []

        def worker():
            try:
                nap = _napper(5)
                while True:
                    td = q.next_ready(timeout=0.01)
                    if td is None:
                        if done.is_set():
                            return
                        continue
                    ran.append(td.tid)
                    nap()
                    q.mark_completed(td)
            except BaseException as e:          # pragma: no cover
                errors.append(e)

        t = threading.Thread(target=worker)
        t.start()
        collected: list[int] = []
        nap = _napper(6)
        for i in range(N_MSGS):
            td = _FakeTD(i)
            while True:
                accepted, back = q.try_put(td)
                if back is not None:
                    collected.append(back.tid)
                if accepted:
                    break
                collected.extend(d.tid for d in q.collect_completed())
                time.sleep(0)
            nap()
        deadline = time.time() + 30
        while len(collected) < N_MSGS and time.time() < deadline:
            collected.extend(d.tid for d in q.collect_completed())
            time.sleep(0)
        done.set()
        t.join(timeout=30)
        assert not t.is_alive()
        assert not errors
        assert ran == list(range(N_MSGS))
        assert sorted(collected) == list(range(N_MSGS))
        assert q.enq_count == N_MSGS
        assert q.occupancy() == 0
        assert all(s.state is SlotState.EMPTY for s in q._slots)

