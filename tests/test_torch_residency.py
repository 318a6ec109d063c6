"""repro_torch's device-resident tiles against repro's, on the CPU.

The port of ``tests/test_residency.py`` and of the sharded timelines of
``tests/test_obs.py``:

* the memory layer: ``TileStore`` swapping (homing is not charged),
  ``DeviceTileStore`` re-committing writes to the home device,
  destination-aware ``materialize``/``gather``, the committed/uncommitted
  rule (host-store tiles and caller values are never charged), and a
  move between two logical devices on one torch device being a real copy;
* the contention-aware owner override: ``rebalance_owners`` equal to the
  reference's on random owner lists and background loads, and
  ``owner_skew_threshold`` end to end;
* the residency counters on every executor, and the sharded executor's
  wave timeline (per-home queue channels draining to zero, per-wave moved
  bytes summing to the stats);
* the reference's two-device programs — striped gemm with homes equal to
  devices (every tile on ``device_assignment[home]``, ``bytes_moved ==
  cross_home_bytes == g³/2 · 4096``, ``tile_moves == g³/2``, zero
  staging, the gather's own moves) and the staged and sharded gemm
  timelines through the in-memory and JSONL sinks and the Chrome export
  — run by the reference on two forced host devices in a subprocess (this
  file run as a script) and by the port on two logical CPU devices, held
  count for count and tile for tile; outputs bit for bit the port's
  sequential run and within 1e-5 + 1e-5·|x| of ``repro``'s.
"""
from __future__ import annotations

import json
import os
import pathlib
import random
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
RTOL = ATOL = 1e-5
FIELDS = ("cross_home_bytes", "local_home_bytes", "tile_moves",
          "bytes_moved", "bytes_staged", "sharded_dispatches",
          "owner_overrides", "grouped_dispatches", "waves")


def _gemm_body(c, a, b):
    return c + a @ b


def run_two_device(pkg: str) -> dict:
    """The reference's two-device programs on ``pkg``: per run its stats
    before and after the read-back, tile locations, the per-wave
    timeline and the outputs (JSON-able)."""
    if pkg == "repro":
        import jax
        from repro import TaskRuntime, dist, task
        from repro.core.placement import device_assignment
        from repro.obs import (InMemoryTracker, JsonlTracker, chrome_trace,
                               load_jsonl, validate_event)
        mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:2]).reshape(2),
                                 ("data",))
        cfg, np_of = {}, np.asarray
    else:
        from repro_torch import TaskRuntime, dist, task
        from repro_torch.core.placement import device_assignment
        from repro_torch.launch.mesh import make_mesh
        from repro_torch.obs import (InMemoryTracker, JsonlTracker,
                                     chrome_trace, load_jsonl,
                                     validate_event)
        mesh = make_mesh((2,), ("data",),
                         devices=dist.logical_devices(2, "cpu"))
        cfg, np_of = {"device": "cpu"}, (lambda t: t.cpu().numpy())
    gemm = task(inout="c", in_=("a", "b"))(_gemm_body)
    rng = np.random.default_rng(0)
    a = rng.standard_normal((128, 128), dtype=np.float32)
    b = rng.standard_normal((128, 128), dtype=np.float32)

    def stats(rt):
        s = rt.stats()
        return {f: getattr(s, f) for f in FIELDS}

    def prog(executor, tracker=None, **overrides):
        g = 4
        rt = TaskRuntime(executor=executor, tracker=tracker, **cfg,
                         **overrides)
        try:
            with rt.scope():
                A = rt.from_array(a, (32, 32), name="A")
                B = rt.from_array(b, (32, 32), name="B")
                C = rt.zeros((128, 128), (32, 32), name="C")
                for i in range(g):
                    for j in range(g):
                        for k in range(g):
                            gemm(C[i, j], A[i, k], B[k, j])
                rt.barrier()
                before = stats(rt)
                out = np_of(C.gather()).tolist()
            tiles = {f"{ba.name}{list(idx)}": getattr(
                ba.tile_device(idx), "id", None)
                for ba in (A, B, C) for idx in ba.block_indices()}
            homes = {f"{ba.name}{list(idx)}": h for ba in (A, B, C)
                     for idx, h in ba.home.items()}
            res = dict(stats=before, after_gather=stats(rt), out=out,
                       tiles=tiles, homes=homes)
        finally:
            rt.shutdown()
        if isinstance(tracker, InMemoryTracker):
            closes = tracker.events_of("wave_close")
            res.update(
                waves_open=len(tracker.events_of("wave_open")),
                wave_moves=[e.data["tile_moves"] for e in closes],
                wave_bytes=[e.data["bytes_moved"] for e in closes],
                wave_staged=[e.data["bytes_staged"] for e in closes],
                executors=sorted({e.data["executor"] for e in closes}),
                modes=[e.data["mode"]
                       for e in tracker.events_of("dispatch")],
                depths=[list(d) for d in
                        sorted(tracker.queue_depths().items())],
                queue_events=len(tracker.events_of("queue_depth")),
                invalid=[ev.kind for ev in tracker.events
                         if validate_event(ev)])
        return res

    runs = {"sequential": prog("sequential"),
            "staged": prog("staged", InMemoryTracker(), n_controllers=2)}
    with dist.use_mesh(mesh) as ctx:
        runs["devmap"] = [d.id for d in device_assignment(2, ctx)]
        runs["residency"] = prog("sharded", placement="striped",
                                 n_controllers=2)
        runs["timeline"] = prog("sharded", InMemoryTracker(),
                                n_controllers=2)
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.jsonl")
            jt = JsonlTracker(path)
            runs["jsonl"] = prog("sharded", jt, n_controllers=2)
            jt.close()
            events = load_jsonl(path)
        doc = chrome_trace(events)
        ts = [e["ts"] for e in doc["traceEvents"] if e["ph"] != "M"]
        runs["jsonl"].update(
            header=events[0].kind,
            wave_bytes=[e.data["bytes_moved"] for e in events
                        if e.kind == "wave_close"],
            chrome_sorted=bool(ts) and ts == sorted(ts) and min(ts) >= 0)
        runs["override_off"] = prog("sharded", n_controllers=2,
                                    owner_skew_threshold=1.5)
        runs["override_on"] = prog("sharded", InMemoryTracker(),
                                   n_controllers=2, owner_skew_threshold=1.5)
    return runs


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT / "src"))
    print(json.dumps(run_two_device("repro")))
    sys.exit(0)

from repro.core import placement as ref_placement  # noqa: E402
from repro_torch import (RuntimeConfig, TaskRuntime, dist,  # noqa: E402
                         task)
from repro_torch.core.blocks import (BlockArray, DeviceTileStore,  # noqa
                                     HostTileStore, TileTraffic, device_of)
from repro_torch.core.placement import (device_assignment,  # noqa: E402
                                        rebalance_owners)
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.obs import InMemoryTracker  # noqa: E402


def cpu_mesh(n: int):
    return make_mesh((n,), ("data",), devices=dist.logical_devices(n, "cpu"))


@task(inout="c", in_=("a", "b"))
def _gemm(c, a, b):
    return c + a @ b


def _rt(**kw) -> TaskRuntime:
    return TaskRuntime(RuntimeConfig(device="cpu", **kw))


def _gemm_program(rt, a, b, tile=32):
    """Run tiled gemm; returns (result, stats-before-gather)."""
    n = a.shape[0]
    g = n // tile
    with rt.scope():
        A = rt.from_array(a, (tile, tile), name="A")
        B = rt.from_array(b, (tile, tile), name="B")
        C = rt.zeros((n, n), (tile, tile), name="C")
        for i in range(g):
            for j in range(g):
                for k in range(g):
                    _gemm(C[i, j], A[i, k], B[k, j])
        rt.barrier()
        s = rt.stats()
        return C.gather().numpy(), s


def _gemm_run(executor, tracker, n=64, tile=32, **overrides):
    """The fixed gemm graph of tests/test_obs.py: g=2, so 8 tasks in 2
    wavefronts of 4 (one group each).  Returns (stats, result)."""
    g = n // tile
    rng = np.random.default_rng(0)
    a = rng.standard_normal((n, n), dtype=np.float32)
    b = rng.standard_normal((n, n), dtype=np.float32)
    with _rt(executor=executor, tracker=tracker, n_workers=2,
             **overrides) as rt:
        A = rt.from_array(a, (tile, tile))
        B = rt.from_array(b, (tile, tile))
        C = rt.zeros((n, n), (tile, tile))
        for i in range(g):
            for j in range(g):
                for k in range(g):
                    _gemm(C[i, j], A[i, k], B[k, j])
        rt.barrier()
        stats = rt.stats()
        out = C.gather().numpy()
    return stats, out


# ---------------------------------------------------------------------------
class TestTileStore:
    def test_default_store_is_host(self):
        ba = BlockArray.from_array(np.zeros((8, 8), np.float32), (4, 4),
                                   device="cpu")
        assert isinstance(ba.store, HostTileStore)
        assert ba.store.device_for((0, 0)) is None
        assert ba.tile_device((0, 0)) is None     # uncommitted host tile

    @pytest.mark.parametrize("ndev", [1, 4])
    def test_device_store_places_tiles_on_homes(self, ndev):
        with dist.use_mesh(cpu_mesh(ndev)) as ctx:
            with _rt(executor="sharded", placement="striped") as rt:
                A = rt.from_array(np.ones((16, 16), np.float32), (4, 4))
                devmap = device_assignment(rt.n_controllers, ctx)
                assert isinstance(A.store, DeviceTileStore)
                for idx in A.block_indices():
                    assert A.tile_device(idx) == \
                        devmap[A.home[idx] % len(devmap)]
                    assert A.store.device_for(idx) == A.tile_device(idx)
                assert {A.tile_device(i).id for i in A.block_indices()} \
                    == set(range(ndev))

    def test_use_store_migration_not_charged(self):
        with dist.use_mesh(cpu_mesh(4)):
            with _rt(executor="sharded") as rt:
                rt.from_array(np.ones((16, 16), np.float32), (4, 4))
                rt.full((16, 16), (4, 4), 2.0)
                assert rt.traffic.tile_moves == 0
                assert rt.traffic.bytes_moved == 0

    def test_no_mesh_keeps_host_store(self):
        with _rt(executor="sharded") as rt:
            A = rt.from_array(np.ones((8, 8), np.float32), (4, 4))
            assert isinstance(A.store, HostTileStore)

    def test_non_sharded_executors_keep_host_store(self):
        with dist.use_mesh(cpu_mesh(2)):
            for ex in ("sequential", "staged", "host"):
                with _rt(executor=ex) as rt:
                    A = rt.zeros((8, 8), (4, 4))
                    assert isinstance(A.store, HostTileStore)

    def test_set_tile_recommits_to_home(self):
        """A write re-commits to the home device wherever the value was
        produced; a value committed elsewhere is one counted move, an
        uncommitted one is free."""
        with dist.use_mesh(cpu_mesh(2)) as ctx:
            with _rt(executor="sharded") as rt:
                A = rt.zeros((8, 8), (4, 4))
                devmap = device_assignment(rt.n_controllers, ctx)
                home = devmap[A.home[(0, 0)] % len(devmap)]
                A.set_tile((0, 0), torch.ones((4, 4)))
                assert A.tile_device((0, 0)) == home
                assert rt.traffic.tile_moves == 0
                # a value produced on the other device: one copy home
                other = A.get_tile((0, 1))
                assert device_of(other) != home
                A.set_tile((0, 0), other)
                assert A.tile_device((0, 0)) == home
                assert rt.traffic.tile_moves == 1
                assert rt.traffic.bytes_moved == A.tile_nbytes
                # the source tile keeps its own location
                assert device_of(other) == A.tile_device((0, 1))

    def test_logical_moves_are_real_copies(self):
        """Two logical devices on one torch device: a move copies the
        storage; committing an uncommitted tensor shares it."""
        with dist.use_mesh(cpu_mesh(2)):
            with _rt(executor="sharded") as rt:
                src = torch.arange(16.0).reshape(4, 4)
                A = rt.zeros((8, 8), (4, 4))
                A.set_tile((0, 0), src)
                homed = A.get_tile((0, 0))
                assert homed.data_ptr() == src.data_ptr()
                assert device_of(src) is None      # the caller's stays
                A.set_tile((0, 1), homed)          # home 1: another device
                moved = A.get_tile((0, 1))
                assert moved.data_ptr() != homed.data_ptr()
                assert torch.equal(moved, src)


class TestDestinationAwareAssembly:
    def test_materialize_accepts_destination(self):
        arr = np.arange(64, dtype=np.float32).reshape(8, 8)
        ba = BlockArray.from_array(arr, (4, 4), device="cpu")
        dev = dist.default_device("cpu")
        out = ba[0:2, 0:2].materialize(device=dev)
        assert tuple(out.shape) == (8, 8)
        np.testing.assert_array_equal(out.numpy(), arr)

    def test_gather_accepts_destination(self):
        arr = np.arange(64, dtype=np.float32).reshape(8, 8)
        ba = BlockArray.from_array(arr, (4, 4), device="cpu")
        np.testing.assert_array_equal(
            ba.gather(device=dist.default_device("cpu")).numpy(), arr)

    def test_single_device_assembly_charges_nothing(self):
        ba = BlockArray.from_array(np.ones((8, 8), np.float32), (4, 4),
                                   device="cpu")
        ba.traffic = TileTraffic()
        ba.whole.materialize()
        ba.gather()
        assert ba.traffic.tile_moves == 0
        assert ba.traffic.bytes_staged == 0

    def test_committed_local_read_counts_local(self):
        with dist.use_mesh(cpu_mesh(1)) as ctx:
            with _rt(executor="sharded") as rt:
                A = rt.from_array(np.ones((8, 8), np.float32), (4, 4))
                A.whole.materialize(device=ctx.mesh.devices.flat[0])
                assert rt.traffic.bytes_local > 0
                assert rt.traffic.tile_moves == 0

    def test_mixed_devices_without_destination_stage(self):
        """No destination over tiles on 4 devices: assembly goes to the
        majority device (the lowest id on a tie) and every moved byte is
        charged as staged; a named destination moves the same tiles
        without staging."""
        arr = np.arange(256, dtype=np.float32).reshape(16, 16)
        with dist.use_mesh(cpu_mesh(4)):
            with _rt(executor="sharded", placement="striped") as rt:
                A = rt.from_array(arr, (4, 4))
                nbytes = A.tile_nbytes
                out = A[0:2, 0:2].materialize()   # homes 0, 1, 0, 1
                np.testing.assert_array_equal(out.numpy(), arr[:8, :8])
                assert rt.traffic.tile_moves == 2
                assert rt.traffic.bytes_staged == 2 * nbytes
                rt.traffic.reset()
                A[0:2, 0:2].materialize(device=A.tile_device((0, 1)))
                assert rt.traffic.tile_moves == 2
                assert rt.traffic.bytes_staged == 0
                assert rt.traffic.bytes_local == 2 * nbytes
                rt.traffic.reset()
                np.testing.assert_array_equal(A.gather().numpy(), arr)
                assert rt.traffic.tile_moves == 12
                assert rt.traffic.bytes_staged == 0


class TestOwnerOverride:
    def test_rebalance_disabled_returns_input(self):
        owners, spilled = rebalance_owners([0, 0, 0, 0], 4, 0.0)
        assert owners == [0, 0, 0, 0] and spilled == 0

    def test_rebalance_spills_hot_home(self):
        owners, spilled = rebalance_owners([0] * 8, 4, 1.5)
        assert spilled > 0
        load = [owners.count(h) for h in range(4)]
        assert max(load) <= 1.5 * (8 / 4)

    def test_rebalance_balanced_wave_untouched(self):
        owners, spilled = rebalance_owners([0, 1, 2, 3] * 4, 4, 1.5)
        assert spilled == 0
        assert owners == [0, 1, 2, 3] * 4

    @pytest.mark.parametrize("seed", range(4))
    def test_rebalance_matches_reference(self, seed):
        rnd = random.Random(seed)
        for _ in range(200):
            homes = rnd.choice([1, 2, 3, 4, 8])
            owners = [rnd.randrange(homes * 2)
                      for _ in range(rnd.randrange(0, 20))]
            thr = rnd.choice([0.0, 1.0, 1.2, 1.5, 3.0])
            base = None if rnd.random() < 0.5 else \
                [rnd.randrange(0, 6) for _ in range(homes)]
            assert rebalance_owners(owners, homes, thr, base_load=base) == \
                ref_placement.rebalance_owners(owners, homes, thr,
                                               base_load=base)

    def test_base_load_validation(self):
        with pytest.raises(ValueError, match="one entry per home"):
            rebalance_owners([0], 4, 1.5, base_load=[1.0, 2.0])
        with pytest.raises(ValueError, match=">= 0"):
            rebalance_owners([0], 4, 1.5, base_load=[1, -1, 0, 0])
        got, spilled = rebalance_owners([0, 0, 1, 2], 4, 1.1,
                                        base_load=[0, 0, 0, 100])
        assert spilled == 0 and got == [0, 0, 1, 2]

    def test_config_knob_validates(self):
        with pytest.raises(ValueError, match="owner_skew_threshold"):
            RuntimeConfig(owner_skew_threshold=-1.0).validate()

    def test_override_counted_and_numerics_hold(self):
        rng = np.random.default_rng(7)
        a = rng.standard_normal((64, 64), dtype=np.float32)
        b = rng.standard_normal((64, 64), dtype=np.float32)
        ref, _ = _gemm_program(_rt(executor="sequential"), a, b)
        with dist.use_mesh(cpu_mesh(4)):
            rt = _rt(executor="sharded", placement="single",
                     owner_skew_threshold=1.5)
            got, s = _gemm_program(rt, a, b)
        np.testing.assert_array_equal(ref, got)
        assert s.owner_overrides and s.owner_overrides > 0
        assert s.cross_home_bytes > 0
        # the spilled tasks' outputs copy home: measured, never staged
        assert s.tile_moves > 0 and s.bytes_staged == 0

    def test_override_off_by_default(self):
        with dist.use_mesh(cpu_mesh(1)):
            rt = _rt(executor="sharded", placement="single")
            a = np.random.default_rng(8).standard_normal(
                (64, 64), dtype=np.float32)
            _gemm_program(rt, a, a)
        s = rt.stats()
        assert s.owner_overrides == 0
        assert s.cross_home_bytes == 0


class TestResidencyStats:
    def test_all_executors_report_residency_fields(self):
        a = np.random.default_rng(9).standard_normal((64, 64),
                                                     dtype=np.float32)
        for ex in ("sequential", "staged", "sharded", "host"):
            rt = _rt(executor=ex)
            try:
                _gemm_program(rt, a, a)
                s = rt.stats()
            finally:
                rt.shutdown()
            assert s.tile_moves == 0
            assert s.bytes_moved == 0
            assert s.bytes_staged == 0
            assert (s.cross_home_bytes is not None) == (ex == "sharded")

    def test_mesh_wave_dispatch_never_stages(self):
        a = np.random.default_rng(10).standard_normal((128, 128),
                                                      dtype=np.float32)
        with dist.use_mesh(cpu_mesh(4)):
            rt = _rt(executor="sharded", placement="striped")
            _, s = _gemm_program(rt, a, a)
        assert s.sharded_dispatches > 0
        assert s.bytes_staged == 0
        assert s.bytes_moved == s.cross_home_bytes > 0


class TestShardedTimeline:
    def test_sharded_timeline_single_device(self):
        trk = InMemoryTracker()
        stats, out = _gemm_run("sharded", trk)
        closes = trk.events_of("wave_close")
        assert len(closes) == 2
        assert all(e.data["executor"] == "sharded" for e in closes)
        depths = trk.queue_depths()
        assert depths and all(d == 0 for d in depths.values())
        assert set(depths) == {0, 1, 2, 3}      # one channel per home

    def test_wave_traffic_sums_to_stats(self):
        trk = InMemoryTracker()
        with dist.use_mesh(cpu_mesh(4)):
            stats, _ = _gemm_run("sharded", trk, n=128)
        closes = trk.events_of("wave_close")
        assert sum(e.data["bytes_moved"] for e in closes) == \
            stats.bytes_moved > 0
        assert sum(e.data["tile_moves"] for e in closes) == stats.tile_moves
        assert sum(e.data["bytes_staged"] for e in closes) == \
            stats.bytes_staged == 0

    def test_sharded_with_tracker_matches_without(self):
        s_off, out_off = _gemm_run("sharded", None,
                                   owner_skew_threshold=1.5)
        trk = InMemoryTracker()
        s_on, out_on = _gemm_run("sharded", trk, owner_skew_threshold=1.5)
        np.testing.assert_array_equal(out_off, out_on)
        assert s_on.owner_overrides == s_off.owner_overrides
        assert s_on.bytes_staged == s_off.bytes_staged == 0
        assert s_on.cross_home_bytes == s_off.cross_home_bytes

    def test_override_event_names_its_wave(self):
        trk = InMemoryTracker()
        with dist.use_mesh(cpu_mesh(2)):
            stats, _ = _gemm_run("sharded", trk, placement="single",
                                 owner_skew_threshold=1.5)
        events = trk.events_of("owner_override")
        assert events and sum(e.data["spilled"] for e in events) == \
            stats.owner_overrides


# ---------------------------------------------------------------------------
# the reference's two-device programs on both packages
@pytest.fixture(scope="module")
def two_device():
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=2",
               JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src"), str(ROOT), env.get("PYTHONPATH", "")])
    out = subprocess.run([sys.executable, __file__], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return {"repro": json.loads(out.stdout.strip().splitlines()[-1]),
            "repro_torch": run_two_device("repro_torch")}


RUNS = ["staged", "residency", "timeline", "jsonl", "override_off",
        "override_on"]


@pytest.mark.parametrize("run", RUNS)
def test_two_device_run_matches_reference(two_device, run):
    port, ref = two_device["repro_torch"][run], two_device["repro"][run]
    assert port.keys() == ref.keys()
    for key, want in ref.items():
        if key != "out":
            assert port[key] == want, key
    np.testing.assert_allclose(np.asarray(port["out"], np.float32),
                               np.asarray(ref["out"], np.float32),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(
        np.asarray(port["out"], np.float32),
        np.asarray(two_device["repro_torch"]["sequential"]["out"],
                   np.float32))


def test_two_device_residency_and_accounting(two_device):
    """The reference's acceptance run on the port: tiles on
    ``device_assignment[home]``, every wave through the per-device
    dispatch, measured moves equal to the footprint prediction, zero
    staging, and the gather's direct moves for half of C's tiles."""
    runs = two_device["repro_torch"]
    assert runs["devmap"] == two_device["repro"]["devmap"] == [0, 1]
    res = runs["residency"]
    for key, dev in res["tiles"].items():
        assert dev == runs["devmap"][res["homes"][key] % 2], key
    s, s2 = res["stats"], res["after_gather"]
    g, block_bytes = 4, 32 * 32 * 4
    assert s["sharded_dispatches"] == 4
    assert s["bytes_staged"] == 0
    assert s["bytes_moved"] == s["cross_home_bytes"] == \
        g ** 3 // 2 * block_bytes
    assert s["tile_moves"] == g ** 3 // 2
    assert s2["bytes_staged"] == 0
    assert s2["bytes_moved"] == s["bytes_moved"] + g * g // 2 * block_bytes


def test_two_device_timelines(two_device):
    runs = two_device["repro_torch"]
    for name, executor in (("staged", "staged"), ("timeline", "sharded"),
                           ("override_on", "sharded")):
        r = runs[name]
        assert r["waves_open"] == len(r["wave_bytes"]) == 4, name
        assert r["executors"] == [executor]
        assert r["queue_events"] > 0 and r["invalid"] == []
        assert all(d == 0 for _, d in r["depths"])
        assert sum(r["wave_bytes"]) == r["stats"]["bytes_moved"]
        assert sum(r["wave_staged"]) == 0
    assert runs["timeline"]["stats"]["bytes_moved"] > 0
    jsonl = runs["jsonl"]
    assert jsonl["header"] == "trace_header" and jsonl["chrome_sorted"]
    assert sum(jsonl["wave_bytes"]) == jsonl["stats"]["bytes_moved"]
    on, off = runs["override_on"], runs["override_off"]
    assert on["stats"]["owner_overrides"] == off["stats"]["owner_overrides"]
    assert on["stats"]["bytes_moved"] == off["stats"]["bytes_moved"]
    assert on["out"] == off["out"]
