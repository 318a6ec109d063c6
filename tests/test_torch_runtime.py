"""repro_torch's runtime layer against repro's, on the CPU.

Tile dtypes, grouping keys, eligibility reasons, firstprivate checks,
synchronization and stats are held against the JAX package on the same
numpy inputs; the fault paths (CUDA asked for but absent, executors the
port does not run yet) must raise rather than substitute something else.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import repro
from repro.core import wavekernel as ref_wk
import repro_torch
import repro_torch.apps
from repro_torch import (RuntimeConfig, RuntimeStats, TaskRuntime,
                         register_wave_kernel, task)
from repro_torch.core import wavekernel
from repro_torch.core.blocks import BlockArray


def _port(**kw):
    kw.setdefault("executor", "staged")
    return TaskRuntime(RuntimeConfig(device="cpu", **kw))


def _ref(**kw):
    kw.setdefault("executor", "staged")
    return repro.TaskRuntime(repro.RuntimeConfig(**kw))


# ---------------------------------------------------------------------------
# tiles
@pytest.mark.parametrize("dtype", [np.float64, np.int64, np.float32,
                                   np.int32, np.complex128, np.bool_])
def test_from_array_canonicalizes_dtypes_like_the_reference(dtype):
    x = (np.arange(16).reshape(4, 4) % 3).astype(dtype)
    port = BlockArray.from_array(x, (2, 2), device="cpu")
    ref = repro.BlockArray.from_array(x, (2, 2))
    assert str(port.get_tile((0, 0)).dtype).removeprefix("torch.") == \
        str(jnp.dtype(ref.dtype))
    np.testing.assert_array_equal(port.gather().numpy(),
                                  np.asarray(ref.gather()))


def test_tiles_are_contiguous_tensors_of_their_own():
    src = torch.arange(64, dtype=torch.float32).reshape(8, 8)
    ba = BlockArray.from_array(src, (4, 8), device="cpu")  # row blocks
    for idx in ba.block_indices():
        tile = ba.get_tile(idx)
        assert tile.is_contiguous()
        assert tile.untyped_storage().data_ptr() != \
            src.untyped_storage().data_ptr()
    src.zero_()                                    # the source may change
    assert ba.gather().sum().item() == sum(range(64))


def test_region_gather_and_store_round_trip():
    x = np.arange(6 * 9, dtype=np.float32).reshape(6, 9)
    ba = BlockArray.from_array(x, (2, 3), device="cpu")
    region = ba[1:3, 0:2]
    np.testing.assert_array_equal(region.materialize().numpy(),
                                  x[2:6, 0:6])
    region.store(torch.zeros(region.shape))
    want = x.copy()
    want[2:6, 0:6] = 0
    np.testing.assert_array_equal(ba.gather().numpy(), want)


# ---------------------------------------------------------------------------
# grouping and eligibility
@task(inout="c", in_="a", firstprivate="alpha")
def _scale(c, a, alpha):
    return c + alpha * a


@repro.task(inout="c", in_="a", firstprivate="alpha")
def _ref_scale(c, a, alpha):
    return c + alpha * a


def _spawn_scales(rt, values):
    """One independent ``scale`` task per value, on either package."""
    fn = _scale if isinstance(rt, TaskRuntime) else _ref_scale
    with rt.scope():
        A = rt.zeros((4 * len(values), 4), (4, 4))
        C = rt.zeros((4 * len(values), 4), (4, 4))
        return [fn(C[i, 0], A[i, 0], v) for i, v in enumerate(values)]


@pytest.mark.parametrize("values", [(1.5, np.float32(2.0)),
                                    (3, np.int64(4)), (2, 2.0),
                                    (np.float64(1.0), 1.0)])
def test_firstprivate_grouping_matches_reference(values):
    port, ref = _port(), _ref()
    p = _spawn_scales(port, values)
    r = _spawn_scales(ref, values)
    same_port = len({wavekernel.group_signature(f.descriptor)[1:]
                     for f in p}) == 1
    same_ref = len({ref_wk.group_signature(f.descriptor)[1:]
                    for f in r}) == 1
    assert same_port == same_ref
    port.barrier()
    ref.barrier()
    assert port.stats().grouped_dispatches == ref.stats().grouped_dispatches


def test_firstprivate_int_bound_is_the_references_int32():
    for rt in (_port(), _ref()):
        _spawn_scales(rt, [2 ** 31 - 1, -2 ** 31])
        with pytest.raises(TypeError, match="overflows"):
            _spawn_scales(rt, [2 ** 31])
        rt.barrier()


@task(inout="v", in_="w")
def _add1d(v, w):
    return v + w


@task(inout="c", in_="m")
def _add_int(c, m):
    return c + m.to(torch.float32)


@task(inout="c", in_="a", firstprivate="v")
def _add_vec(c, a, v):
    return c + a + v.sum()


def test_eligibility_reasons_in_reference_order(monkeypatch):
    def reasons(program, **kw):
        rt = _port(kernel_backend="pallas", tracker="memory", **kw)
        with rt:
            program(rt)
        return [e.data["reason"] for e in rt.obs.events_of("kernel_dispatch")]

    def one_task(rt):
        A = rt.zeros((4,), (4,))
        _add1d(A[0], A[0])

    def rank1(rt):
        A = rt.zeros((8,), (4,))
        B = rt.zeros((8,), (4,))
        _add1d(A[0], B[0])
        _add1d(A[1], B[1])

    def mixed(rt):
        C = rt.zeros((8, 4), (4, 4))
        M = rt.zeros((8, 4), (4, 4), dtype=torch.int32)
        _add_int(C[0, 0], M[0, 0])
        _add_int(C[1, 0], M[1, 0])

    def vector_fp(rt):
        A = rt.zeros((8, 4), (4, 4))
        C = rt.zeros((8, 4), (4, 4))
        _add_vec(C[0, 0], A[0, 0], np.ones(2, np.float32))
        _add_vec(C[1, 0], A[1, 0], np.ones(2, np.float32))

    def two_scale(rt):
        A = rt.zeros((8, 4), (4, 4))
        C = rt.zeros((8, 4), (4, 4))
        _scale(C[0, 0], A[0, 0], 1.0)
        _scale(C[1, 0], A[1, 0], 2.0)

    assert reasons(one_task) == ["single_task"]
    assert reasons(rank1) == ["non_rectangular"]
    assert reasons(mixed) == ["mixed_dtype"]
    assert reasons(vector_fp) == ["nonscalar_firstprivate"]
    assert reasons(two_scale) == ["no_kernel"]
    assert reasons(two_scale, group_waves=False) == ["ungrouped"]
    monkeypatch.setattr(wavekernel, "MAX_GRID_TASKS", 1)
    assert reasons(two_scale) == ["grid_overflow"]


def test_registered_kernel_gets_stacked_operands_and_out_shapes():
    seen = {}

    @task(inout="c", in_="a", firstprivate=("alpha", "k"))
    def axpy(c, a, alpha, k):
        return c + alpha * a + k

    def batched(c, a, alpha, k, out_shapes):
        seen.update(shapes=[tuple(x.shape) for x in (c, a, alpha, k)],
                    dtypes=(alpha.dtype, k.dtype), out_shapes=out_shapes)
        return c + alpha[:, None, None] * a + k[:, None, None]

    register_wave_kernel(axpy, batched)
    with _port(kernel_backend="pallas") as rt:
        A = rt.full((8, 4), (4, 4), 1.0)
        C = rt.zeros((8, 4), (4, 4))
        f0 = axpy(C[0, 0], A[0, 0], 2.0, 1)
        f1 = axpy(C[1, 0], A[1, 0], 3.0, 2)
        rt.barrier()
        assert rt.stats().kernel_dispatches == 1
    assert seen == dict(shapes=[(2, 4, 4), (2, 4, 4), (2,), (2,)],
                        dtypes=(torch.float32, torch.int64),
                        out_shapes=((4, 4),))
    assert torch.equal(f0.result(), torch.full((4, 4), 3.0))
    assert torch.equal(f1.result(), torch.full((4, 4), 5.0))


# ---------------------------------------------------------------------------
# synchronization, futures, stats
def test_futures_and_region_waits_force_only_their_cone():
    with _port(tracker="memory") as rt:
        A = rt.full((8, 8), (4, 4), 1.0)
        C = rt.zeros((8, 8), (4, 4))
        f00 = _scale(C[0, 0], A[0, 0], 2.0)
        f11 = _scale(C[1, 1], A[1, 1], 3.0)
        assert torch.equal(f00.result(), torch.full((4, 4), 2.0))
        assert f00.done() and not f11.done()
        rt.wait_on(C[1, 1])
        assert f11.done()
        assert rt.wait_all([f00, f11])[1][0, 0].item() == 3.0
        stats = rt.stats()
    assert stats.futures_resolved == 3 and stats.region_waits == 1


def test_stats_json_round_trip_keeps_the_reference_schema():
    with _port(kernel_backend="pallas") as rt:
        A = rt.full((8, 8), (4, 4), 1.0)
        _scale(A[0, 0], A[1, 1], 1.0)
    s = rt.stats()
    assert RuntimeStats.from_json(s.to_json()) == s
    assert s.to_dict()["schema"] == repro.STATS_SCHEMA
    ref_fields = {f.name for f in dataclasses.fields(repro.RuntimeStats)}
    assert {f.name for f in dataclasses.fields(RuntimeStats)} == ref_fields


def test_config_fields_enums_and_defaults_match_reference():
    port = {f.name: f.default for f in dataclasses.fields(RuntimeConfig)}
    ref = {f.name: f.default for f in dataclasses.fields(repro.RuntimeConfig)}
    assert port.pop("device") == "cuda"
    assert port == ref
    for name in ("EXECUTORS", "DEP_MANAGERS", "DEP_PUMPS",
                 "SCHEDULING_POLICIES", "PLACEMENTS", "KERNEL_BACKENDS"):
        assert getattr(repro_torch, name) == getattr(repro, name)
    cfg = RuntimeConfig(executor=repro_torch.ExecutorKind.STAGED,
                        kernel_backend=repro.KernelBackend.PALLAS,
                        device="cpu").validate()
    assert (type(cfg.executor), cfg.executor, cfg.kernel_backend) == \
        (str, "staged", "pallas")
    with pytest.raises(ValueError):
        RuntimeConfig(device="tpu").validate()


@pytest.mark.parametrize("placement", ["single", "striped", "striped_diag",
                                       "striped_rows"])
def test_block_homes_match_reference(placement):
    x = np.zeros((12, 8), np.float32)
    port = _port(placement=placement, n_controllers=3).from_array(x, (2, 4))
    ref = _ref(placement=placement, n_controllers=3).from_array(x, (2, 4))
    assert port.home == ref.home


# ---------------------------------------------------------------------------
# fault paths
def test_cuda_device_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TaskRuntime(RuntimeConfig(executor="staged"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        repro_torch.apps.run_app("matmul", app_kwargs=dict(n=64, tile=32))


@pytest.mark.parametrize("overrides", [
    dict(executor="host"),                                    # item 4
    dict(executor="staged", dep_manager="sharded"),           # item 6
    dict(executor="staged", dep_manager="sharded", dep_pump="sync"),
    dict(executor="host", dep_manager="sharded", dep_pump="threaded"),
], ids=["host", "sharded-auto", "sharded-sync", "host-sharded-threaded"])
def test_ported_executors_run(overrides):
    rt = TaskRuntime(RuntimeConfig(device="cpu", **overrides))
    try:
        assert rt.executor_kind == overrides["executor"]
        if overrides.get("dep_manager") == "sharded":
            assert rt.dep_pump in ("sync", "threaded")
            assert overrides.get("dep_pump", rt.dep_pump) == rt.dep_pump
            assert rt.stats().dep_messages == 0
        with rt.scope():
            A = rt.full((8, 8), (4, 4), 1.0)
            C = rt.zeros((8, 8), (4, 4))
            fut = _scale(C[1, 0], A[0, 1], 3.0)
            assert torch.equal(fut.result(), torch.full((4, 4), 3.0))
        if overrides.get("dep_manager") == "sharded":
            assert rt.stats().dep_messages > 0
    finally:
        rt.shutdown()


@pytest.mark.parametrize("overrides,item", [
    (dict(executor="sim"), "item 7"),
    (dict(executor="sharded"), "item 9"),
    (dict(executor="staged", sim_cost_fn=lambda td: (0, 0)), "item 7"),
])
def test_unported_executors_raise_not_implemented(overrides, item):
    """The name is historical: every executor is ported now.  Item 7's
    sim executor runs (timing only), ``sim_cost_fn`` is inert under the
    staged executor, and item 9's sharded executor runs (with no mesh, as
    the staged one), each the reference's executor class."""
    ref = repro.TaskRuntime(repro.RuntimeConfig(**overrides))
    with TaskRuntime(RuntimeConfig(device="cpu", **overrides)) as rt:
        assert type(rt._exec).__name__ == type(ref._exec).__name__
        assert rt.executor_kind == overrides["executor"]
        with rt.scope():
            A = rt.full((8, 8), (4, 4), 1.0)
            C = rt.zeros((8, 8), (4, 4))
            _scale(C[1, 0], A[0, 1], 3.0)
            rt.barrier()
    ref.shutdown()
    st = rt.stats()
    assert st.tasks_spawned == 1
    if overrides["executor"] == "sim":
        assert st.predicted_total_s > 0
        assert torch.count_nonzero(C.gather()) == 0     # timing only
    else:
        assert st.predicted_total_s is None
        assert torch.equal(C.get_tile((1, 0)), torch.full((4, 4), 3.0))


def test_default_executor_is_the_references_and_is_not_ported_yet():
    """The name is historical: the default executor, the reference's
    "host", is ported now and ``TaskRuntime()`` runs on it."""
    assert RuntimeConfig().executor == repro.RuntimeConfig().executor
    with TaskRuntime(device="cpu") as rt:
        A = rt.full((8, 8), (4, 4), 1.0)
        C = rt.zeros((8, 8), (4, 4))
        fut = _scale(C[1, 0], A[0, 1], 3.0)
        assert torch.equal(fut.result(), torch.full((4, 4), 3.0))
    assert rt.executor_kind == "host"
    assert rt.stats().worker_tasks is not None
    assert not any(w.is_alive() for w in rt._exec.workers)


def test_registered_kernel_errors_are_not_swallowed():
    @task(inout="c", in_="a")
    def broken(c, a):
        return c + a

    def bad_kernel(c, a, out_shapes):
        raise RuntimeError("launch failed")

    register_wave_kernel(broken, bad_kernel)
    rt = _port(kernel_backend="pallas")
    with rt.scope():
        A = rt.zeros((8, 4), (4, 4))
        B = rt.zeros((8, 4), (4, 4))
        broken(A[0, 0], B[0, 0])
        broken(A[1, 0], B[1, 0])
    with pytest.raises(RuntimeError, match="launch failed"):
        rt.barrier()
