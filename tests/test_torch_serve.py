"""repro_torch.serve and repro_torch.ckpt against repro.serve / repro.ckpt.

* Every case of the reference's ``tests/test_serve.py``, replayed on the
  port (staged executor on the CPU, as there, and the host executor for
  ``poll``).  One difference is deliberate: the port does not run the
  sim executor yet, so a session asked for it raises the runtime's
  ``NotImplementedError`` instead of the session's ``ValueError``.
* The admission counters of a 96-request burst stream with the
  ``reject`` policy equal ``benchmarks/serving.py``'s ``run_admission``.
* A tile checkpoint written by either package restores bit-identically
  in the other.
* ``repro_torch.serve_lm.run`` against the reference example's
  ``_partial``/``_combine`` graph on the same inputs, at 1e-5.
"""
import importlib.util
import pathlib
import time

import numpy as np
import pytest
import torch

import repro
from benchmarks import serving as ref_serving
from repro.ckpt import restore_tiles as ref_restore_tiles
from repro.ckpt import save_tiles as ref_save_tiles
from repro.serve import ServeConfig as RefServeConfig, Session as RefSession
from repro_torch import RuntimeConfig, TaskRuntime, serve_lm, task
from repro_torch.ckpt import latest_epoch, restore_tiles, save_tiles
from repro_torch.interop import blockarray_from_numpy, tiles_to_numpy
from repro_torch.obs import InMemoryTracker
from repro_torch.serve import (AdmissionController, RequestRejected,
                               ServeConfig, Session, footprint_nbytes)
from repro_torch.serve.admission import ADMIT, DEFER, REJECT

ROOT = pathlib.Path(__file__).resolve().parent.parent

TILE = (4, 8)
TILE_BYTES = 4 * 8 * 4          # float32
ROW_BYTES = 8 * 4
REQ_BYTES = TILE_BYTES + ROW_BYTES


def _cfg(executor="staged", **kw):
    return RuntimeConfig(executor=executor, device="cpu", **kw)


@task(in_="src", out="dest")
def _double(src, dest=None):
    return (src * 2.0)[:1]      # (4, 8) tile -> (1, 8) output row


@task(inout="x")
def _bump(x):
    return x + 1.0


def _session(budget_requests=4, **kw):
    kw.setdefault("on_saturation", "queue")
    serve = ServeConfig(budget_bytes=budget_requests * REQ_BYTES, **kw)
    return Session(_cfg(), serve)


def _arrays(s, n_tiles=8, n_slots=8):
    kv = s.from_array(
        np.arange(n_tiles * 4 * 8, dtype=np.float32).reshape(n_tiles * 4, 8),
        TILE, name="kv")
    out = s.zeros((n_slots, 8), (1, 8), name="out", state=False)
    return kv, out


def _req(s, kv, out, i, n_tiles=8, n_slots=8):
    src, dst = kv[i % n_tiles, 0], out[i % n_slots, 0]
    return s.submit(lambda: _double(src, dst), src, dst)


# ---------------------------------------------------------------------------
class TestFootprint:
    def test_counts_distinct_tiles_once(self):
        with Session(_cfg()) as s:
            kv, out = _arrays(s)
            assert footprint_nbytes([kv[0, 0]]) == TILE_BYTES
            assert footprint_nbytes([kv[0, 0], kv[0, 0]]) == TILE_BYTES
            assert footprint_nbytes([kv[0, 0], kv[1, 0]]) == 2 * TILE_BYTES
            assert footprint_nbytes([kv[0, 0], out[0, 0]]) == REQ_BYTES

    def test_whole_array_and_type_errors(self):
        with Session(_cfg()) as s:
            kv, _ = _arrays(s)
            assert footprint_nbytes([kv]) == 8 * TILE_BYTES
            with pytest.raises(TypeError, match="Region or BlockArray"):
                footprint_nbytes([np.zeros(3)])


# ---------------------------------------------------------------------------
class TestAdmissionController:
    def test_decisions_and_ledger(self):
        ac = AdmissionController(100, on_saturation="queue")
        assert ac.try_admit("a", 60) == ADMIT
        assert ac.try_admit("b", 60) == DEFER          # over budget
        assert ac.try_admit("big", 101) == REJECT      # oversize, always
        ac.release("a", 60)
        assert ac.has_room(60)
        ac.admit_deferred("b", 60)
        assert ac.submitted == 3
        assert ac.admitted == 2 and ac.rejected == 1 and ac.deferred == 1
        assert ac.peak_in_flight_bytes == 60

    def test_reject_policy_sheds_instead_of_queueing(self):
        ac = AdmissionController(100, on_saturation="reject")
        assert ac.try_admit("a", 80) == ADMIT
        assert ac.try_admit("b", 80) == REJECT
        assert ac.admitted + ac.rejected == ac.submitted == 2

    def test_depth_backpressure_defers_until_rings_drain(self):
        depths = {0: 5}
        ac = AdmissionController(1000, on_saturation="queue",
                                 max_home_depth=2,
                                 depths_fn=lambda: depths)
        assert ac.try_admit("a", 10) == DEFER
        assert not ac.has_room(10)
        depths.clear()
        assert ac.try_admit("b", 10) == ADMIT

    def test_validation(self):
        with pytest.raises(ValueError, match="budget_bytes"):
            AdmissionController(0)
        with pytest.raises(ValueError, match="on_saturation"):
            AdmissionController(1, on_saturation="panic")
        with pytest.raises(ValueError, match="max_home_depth"):
            AdmissionController(1, max_home_depth=-1)


# ---------------------------------------------------------------------------
class TestServeConfig:
    def test_validation(self):
        with pytest.raises(ValueError, match="budget_bytes"):
            ServeConfig(budget_bytes=0)
        with pytest.raises(ValueError, match="on_saturation"):
            ServeConfig(on_saturation="drop")
        with pytest.raises(ValueError, match="checkpoint_dir"):
            ServeConfig(checkpoint_every=5)

    def test_sim_executor_refused(self):
        """The sim executor is ported and never computes task values, so
        the session refuses it, as the reference's does."""
        with pytest.raises(ValueError, match="timing-only"):
            Session(_cfg("sim"))

    def test_runtime_and_config_are_exclusive(self):
        with TaskRuntime(executor="staged", device="cpu") as rt:
            with pytest.raises(ValueError, match="not both"):
                Session(_cfg(), runtime=rt)


# ---------------------------------------------------------------------------
class TestSessionStream:
    def test_budget_bounds_thousand_request_stream(self):
        trk = InMemoryTracker()
        budget = 4 * REQ_BYTES
        with Session(_cfg(tracker=trk),
                     ServeConfig(budget_bytes=budget)) as s:
            kv, out = _arrays(s)
            handles = [_req(s, kv, out, i) for i in range(1000)]
            s.drain()
            st = s.stats()
        assert st.admission_submitted == 1000
        assert st.admission_admitted + st.admission_rejected == 1000
        assert st.admission_rejected == 0          # queueing, not shedding
        assert 0 < st.admission_peak_bytes <= budget
        assert st.admission_budget_bytes == budget
        assert all(h.done() for h in handles)
        highwater = [e.data["in_flight_bytes"]
                     for e in trk.events if e.kind.startswith("admission_")]
        assert highwater and max(highwater) <= budget

    def test_results_and_state_are_correct(self):
        with _session() as s:
            kv, out = _arrays(s)
            h = _req(s, kv, out, 2)
            h.wait()
            expect = kv.get_tile((2, 0))[:1] * 2.0
            assert torch.equal(out.get_tile((2, 0)), expect)
            assert h.latency_s is not None and h.latency_s >= 0

    def test_reject_policy_sheds_and_result_raises(self):
        with _session(budget_requests=2, on_saturation="reject") as s:
            kv, out = _arrays(s)
            handles = [_req(s, kv, out, i) for i in range(6)]
            states = [h.state for h in handles]
            assert states.count("admitted") == 2
            assert states.count("rejected") == 4
            with pytest.raises(RequestRejected):
                handles[-1].result()
            s.drain()
            st = s.stats()
        assert st.admission_admitted == 2 and st.admission_rejected == 4
        assert st.admission_peak_bytes == 2 * REQ_BYTES

    def test_oversize_request_always_rejected(self):
        with _session(budget_requests=1) as s:
            kv, out = _arrays(s)
            big = s.submit(lambda: _double(kv[0, 0], out[0, 0]),
                           kv[0, 0], kv[1, 0], kv[2, 0], out[0, 0])
            assert big.rejected()
            ok = _req(s, kv, out, 3)
            assert ok.result() is not None

    def test_deferred_requests_admit_fifo(self):
        with _session(budget_requests=1) as s:
            kv, out = _arrays(s)
            handles = [_req(s, kv, out, i) for i in range(5)]
            assert [h.state for h in handles] == \
                ["admitted"] + ["queued"] * 4
            s.drain()
            done = sorted(handles, key=lambda h: h.done_ts)
        assert [h.name for h in done] == [h.name for h in handles]

    def test_wait_forces_only_the_requests_cone(self):
        with _session() as s:
            kv, out = _arrays(s)
            h1 = _req(s, kv, out, 0)
            h2 = _req(s, kv, out, 1)
            h2.wait()
            assert h2.done() and not h1.done()
            h1.wait()
            assert h1.done()

    def test_poll_retires_under_the_host_executor(self):
        with Session(_cfg("host", n_workers=2),
                     ServeConfig(budget_bytes=8 * REQ_BYTES)) as s:
            kv, out = _arrays(s)
            handles = [_req(s, kv, out, i) for i in range(8)]
            deadline = time.time() + 30
            while not all(h.done() for h in handles) \
                    and time.time() < deadline:
                s.poll()
                time.sleep(0.001)
            assert all(h.done() for h in handles)

    def test_submit_errors(self):
        s = _session()
        kv, out = _arrays(s)
        with pytest.raises(ValueError, match="non-empty footprint"):
            s.submit(lambda: None)
        s.close()
        with pytest.raises(RuntimeError, match="closed"):
            _req(s, kv, out, 0)

    def test_state_arrays_need_names(self):
        with Session(_cfg()) as s:
            with pytest.raises(ValueError, match="explicit name"):
                s.zeros((4, 8), TILE)
            s.zeros((4, 8), TILE, name="a")
            with pytest.raises(ValueError, match="already registered"):
                s.zeros((4, 8), TILE, name="a")
            s.zeros((4, 8), TILE, state=False)

    def test_stats_fields_absent_without_a_session(self):
        with TaskRuntime(executor="staged", device="cpu") as rt:
            st = rt.stats()
        assert st.admission_submitted is None
        assert st.admission_peak_bytes is None


# ---------------------------------------------------------------------------
class TestCheckpointRestore:
    def _run(self, s, kv, out, n):
        for i in range(n):
            s.submit(lambda: _bump(kv[i % 8, 0]), kv[i % 8, 0])
        s.drain()

    def _tiles(self, ba):
        return {idx: ba.get_tile(idx).clone() for idx in ba.home}

    def test_restart_restores_bit_identical_state(self, tmp_path):
        ckpt = str(tmp_path / "ckpt")
        with Session(_cfg(), ServeConfig(checkpoint_dir=ckpt)) as s:
            kv, out = _arrays(s)
            self._run(s, kv, out, 13)
            assert s.checkpoint(sync=True) == 1
            self._run(s, kv, out, 7)
            assert s.checkpoint(sync=True) == 2
            expect = self._tiles(kv)
        with Session(_cfg(), ServeConfig(checkpoint_dir=ckpt)) as s2:
            kv2 = s2.zeros((8 * 4, 8), TILE, name="kv")
            assert s2.restore_latest() == 3
            got = self._tiles(kv2)
            assert set(got) == set(expect)
            for idx in expect:
                assert torch.equal(got[idx], expect[idx])
                assert got[idx].dtype == expect[idx].dtype
            self._run(s2, kv2, None, 3)
            assert s2.checkpoint(sync=True) == 4

    def test_async_checkpoint_commits_by_close(self, tmp_path):
        ckpt = str(tmp_path / "ckpt")
        with Session(_cfg(), ServeConfig(checkpoint_dir=ckpt)) as s:
            kv, out = _arrays(s)
            self._run(s, kv, out, 4)
            assert s.checkpoint() == 1
        assert latest_epoch(ckpt) == 2

    def test_auto_checkpoint_every_n_requests(self, tmp_path):
        ckpt = str(tmp_path / "ckpt")
        with Session(_cfg(),
                     ServeConfig(checkpoint_dir=ckpt, checkpoint_every=2,
                                 async_checkpoint=False)) as s:
            kv, out = _arrays(s)
            self._run(s, kv, out, 4)
        assert latest_epoch(ckpt) >= 2

    def test_epoch_layout_on_disk(self, tmp_path):
        ckpt = tmp_path / "ckpt"
        with Session(_cfg(), ServeConfig(checkpoint_dir=str(ckpt))) as s:
            _arrays(s)
            s.checkpoint(sync=True)
        epoch = ckpt / "epoch_00000001"
        assert (epoch / "manifest.json").is_file()
        assert (epoch / "_COMMITTED").is_file()
        assert list(epoch.glob("home_*.npz"))

    def test_restore_with_no_checkpoint_is_none(self, tmp_path):
        with Session(_cfg(), ServeConfig(checkpoint_dir=str(tmp_path))) as s:
            _arrays(s)
            assert s.restore_latest() is None

    def test_restore_refuses_geometry_mismatch(self, tmp_path):
        ckpt = str(tmp_path / "ckpt")
        with Session(_cfg(), ServeConfig(checkpoint_dir=ckpt)) as s:
            _arrays(s)
            s.checkpoint(sync=True)
        with Session(_cfg(), ServeConfig(checkpoint_dir=ckpt)) as s2:
            s2.zeros((8 * 4, 8), (2, 8), name="kv")
            with pytest.raises(ValueError):
                s2.restore_latest()

    def test_checkpoint_requires_configuration(self):
        with Session(_cfg()) as s:
            _arrays(s)
            with pytest.raises(RuntimeError, match="checkpoint_dir"):
                s.checkpoint()
            with pytest.raises(RuntimeError, match="checkpoint_dir"):
                s.restore_latest()


# ---------------------------------------------------------------------------
class TestObservability:
    def test_admission_and_ckpt_events_emitted(self, tmp_path):
        trk = InMemoryTracker()
        with Session(_cfg(tracker=trk),
                     ServeConfig(budget_bytes=REQ_BYTES,
                                 checkpoint_dir=str(tmp_path))) as s:
            kv, out = _arrays(s)
            handles = [_req(s, kv, out, i) for i in range(3)]
            s.drain()
            s.checkpoint(sync=True)
            s.restore_latest()
        kinds = {e.kind for e in trk.events}
        assert {"admission_admit", "admission_defer", "admission_release",
                "ckpt_save", "ckpt_restore"} <= kinds
        admit = trk.events_of("admission_admit")[0]
        assert admit.data["bytes"] == REQ_BYTES
        save = trk.events_of("ckpt_save")[0]
        assert save.data["epoch"] == 1 and save.data["arrays"] == 1
        assert all(h.done() for h in handles)

    def test_reject_events_carry_the_reason(self):
        trk = InMemoryTracker()
        with Session(_cfg(tracker=trk),
                     ServeConfig(budget_bytes=REQ_BYTES,
                                 on_saturation="reject")) as s:
            kv, out = _arrays(s)
            _req(s, kv, out, 0)
            _req(s, kv, out, 1)
            s.drain()
        (rej,) = trk.events_of("admission_reject")
        assert rej.data["reason"] == "budget"


# ---------------------------------------------------------------------------
# the serving benchmark's admission phase, counter for counter
@task(in_="kv", out="dest", firstprivate=("q",))
def _attend(kv, q, dest=None):
    # one decode step against one context tile: softmax(q.kv^T).kv
    d = kv.shape[-1]
    w = torch.softmax(q @ kv.mT / np.float32(np.sqrt(d)), dim=-1)
    return (w @ kv)[None, :]


def _port_admission(n_requests, burst, capacity):
    d, ctx = ref_serving.D, ref_serving.CTX_TILE
    budget = ref_serving.request_bytes(capacity)
    with Session(_cfg(), ServeConfig(budget_bytes=budget,
                                     on_saturation="reject")) as s:
        rng = np.random.default_rng(7)
        kv = s.from_array(rng.standard_normal((8 * ctx, d)).astype(
            np.float32), (ctx, d), name="kv")
        out = s.zeros((burst, d), (1, d), name="out", state=False)
        q = torch.ones(d)
        i = 0
        while i < n_requests:
            for j in range(min(burst, n_requests - i)):
                src, dst = kv[(i + j) % 8, 0], out[j, 0]
                s.submit(lambda src=src, dst=dst: _attend(src, q, dst),
                         src, dst)
            i += min(burst, n_requests - i)
            s.drain()
        st = s.stats()
    return dict(submitted=st.admission_submitted,
                admitted=st.admission_admitted,
                rejected=st.admission_rejected,
                peak_in_flight_bytes=st.admission_peak_bytes,
                budget_bytes=budget)


def test_burst_admission_counters_match_the_reference():
    ref = ref_serving.run_admission(96, 8, 4)
    ref.pop("wall_s")
    assert _port_admission(96, 8, 4) == ref
    assert ref["admitted"] + ref["rejected"] == 96


# ---------------------------------------------------------------------------
# checkpoints across the two packages
def _ref_arrays(shape, block, seed):
    rng = np.random.default_rng(seed)
    rt = repro.TaskRuntime(executor="staged")
    a = rt.from_array(rng.standard_normal(shape).astype(np.float32), block,
                      name="a")
    b = rt.from_array(rng.integers(0, 9, shape).astype(np.int32), block,
                      name="b")
    return rt, {"a": a, "b": b}


def test_reference_checkpoint_restores_bit_identically_in_the_port(tmp_path):
    rt, arrays = _ref_arrays((16, 8), (4, 8), 0)
    ref_save_tiles(str(tmp_path), 3, arrays, meta={"by": "reference"})
    rt.shutdown()
    with TaskRuntime(executor="staged", device="cpu") as prt:
        port = {"a": prt.zeros((16, 8), (4, 8)),
                "b": prt.zeros((16, 8), (4, 8), dtype=torch.int32)}
        assert latest_epoch(str(tmp_path)) == 3
        epoch, meta = restore_tiles(str(tmp_path), port)
    assert (epoch, meta) == (3, {"by": "reference"})
    for name in arrays:
        want = {idx: np.asarray(arrays[name].get_tile(idx))
                for idx in arrays[name].home}
        got = tiles_to_numpy(port[name])
        assert set(got) == set(want)
        for idx in want:
            assert got[idx].dtype == want[idx].dtype
            np.testing.assert_array_equal(got[idx], want[idx])


def test_port_checkpoint_restores_bit_identically_in_the_reference(tmp_path):
    rng = np.random.default_rng(1)
    with TaskRuntime(executor="staged", device="cpu") as prt:
        port = {
            "a": prt.register(blockarray_from_numpy(
                {(i, 0): rng.standard_normal((4, 8)).astype(np.float32)
                 for i in range(4)}, (16, 8), (4, 8), np.float32, "cpu")),
            "b": prt.from_array(rng.integers(0, 9, (16, 8)).astype(
                np.int32), (4, 8))}
        save_tiles(str(tmp_path), 5, port, async_save=True).join()
    rt = repro.TaskRuntime(executor="staged")
    ref = {"a": rt.zeros((16, 8), (4, 8)),
           "b": rt.zeros((16, 8), (4, 8), dtype=np.int32)}
    epoch, _ = ref_restore_tiles(str(tmp_path), ref)
    rt.shutdown()
    assert epoch == 5
    for name in port:
        for idx, want in tiles_to_numpy(port[name]).items():
            got = np.asarray(ref[name].get_tile(idx))
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# serve_lm against the reference example's request graph
def _load_example():
    spec = importlib.util.spec_from_file_location(
        "serve_lm_example", ROOT / "examples" / "serve_lm.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


SMALL = dict(s_tile=16, d=32, n_tiles=8, shards=3, requests=10, budget=2,
             workers=2)


def _reference_rows(sizes, seed=0):
    """The example's request graph (its ``_partial``/``_combine`` tasks)
    on the reference host executor, with serve_lm.run's inputs."""
    ex = _load_example()
    s_tile, d, n_tiles, shards, n_req = (sizes[k] for k in (
        "s_tile", "d", "n_tiles", "shards", "requests"))
    rng = np.random.default_rng(seed)
    k_init = rng.standard_normal((n_tiles * s_tile, d)).astype(np.float32)
    v_init = rng.standard_normal((n_tiles * s_tile, d)).astype(np.float32)
    queries = rng.standard_normal((n_req, d)).astype(np.float32)
    windows = rng.integers(0, n_tiles - shards + 1, n_req)
    with RefSession(repro.RuntimeConfig(executor="host", n_workers=2),
                    RefServeConfig()) as s:
        K = s.from_array(k_init, (s_tile, d), name="K")
        V = s.from_array(v_init, (s_tile, d), name="V")
        OP = s.zeros((n_req * shards, d), (1, d), name="op", state=False)
        LSE = s.zeros((n_req * shards, 1), (1, 1), name="lse", state=False)
        OUT = s.zeros((n_req, d), (1, d), name="out", state=False)
        for i in range(n_req):
            t0, q, r0 = int(windows[i]), queries[i], i * shards

            def graph(t0=t0, q=q, r0=r0, i=i):
                futs = [ex._partial(K[t0 + j, 0], V[t0 + j, 0], q,
                                    OP[r0 + j, 0], LSE[r0 + j, 0])
                        for j in range(shards)]
                futs.append(ex._combine(OP[r0:r0 + shards, 0],
                                        LSE[r0:r0 + shards, 0], OUT[i, 0]))
                return futs

            s.submit(graph, K[t0:t0 + shards, 0], V[t0:t0 + shards, 0],
                     OP[r0:r0 + shards, 0], LSE[r0:r0 + shards, 0],
                     OUT[i, 0])
        s.drain()
        return np.asarray(OUT.gather())


@pytest.mark.parametrize("executor", ["host", "staged"])
def test_serve_lm_matches_the_reference_example(executor, tmp_path):
    want = _reference_rows(SMALL)
    r = serve_lm.run(RuntimeConfig(executor=executor, device="cpu"),
                     ckpt_dir=str(tmp_path), **SMALL)
    np.testing.assert_allclose(r["out"].numpy(), want, rtol=1e-5, atol=1e-5)
    st = r["stats"]
    assert r["rows_verified"] == SMALL["requests"]
    assert st.admission_submitted == st.admission_admitted == 10
    assert st.admission_peak_bytes <= st.admission_budget_bytes == \
        SMALL["budget"] * serve_lm.request_bytes(16, 32, 3)
    assert st.tasks_spawned == 10 * (3 + 1)
    assert (r["epoch"], r["restored_epoch"]) == (1, 2)
    assert r["restore_identical"]
    # the restarted session's close commits the epoch after the restored
    # one, as the example's does
    assert latest_epoch(str(tmp_path)) == 3


def test_serve_lm_defaults_are_the_examples():
    ex = _load_example()
    assert (serve_lm.S_TILE, serve_lm.D, serve_lm.N_TILES,
            serve_lm.SHARDS) == (ex.S_TILE, ex.D, ex.N_TILES, ex.SHARDS)
    c = serve_lm.CHIP_SIZES
    assert c["d"] == 128 and c["n_tiles"] * c["s_tile"] == 131072
    assert c["requests"] * c["shards"] == 4096
