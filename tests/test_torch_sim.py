"""The port's sim executor, cost model, calibration and flop counter
against the JAX package's.

* The DES (``simulate``, ``sequential_time``, ``predict_dep_traffic``) is
  pure Python in both packages: on the same task lists
  (``benchmarks.workloads.WORKLOADS`` carried field by field) at 1, 8 and
  43 workers, central and four sharded managers at batch lines 1 and 4,
  the results are equal, ``==``.
* ``fit_params``/``calibrate``/``granularity_sweep`` give equal results.
* ``H100Params`` holds the H100's data-sheet figures, none of the TPU's.
* ``FlopcountCost``: every body of the five apps is counted (no footprint
  fallback), ``_gemm``/``_update`` at exactly 2MNK plus the elementwise
  term in both packages, every other gap pinned below with its cause.
* The five apps under ``executor="sim"``: ``predicted_total_s`` equal to
  the reference's where the bodies cost the same, the other gaps pinned;
  under ``kernel_backend="pallas"`` the predicted dispatches are what the
  port's staged executor launches, and the reference's equal the port's
  plus its ``no_kernel`` fallbacks (five apps and the 60 fuzz seeds).
* The reference's ``tests/test_calibration.py`` cases, ported.
"""
import dataclasses
import random
from collections import Counter

import numpy as np
import pytest
import torch

import fuzz_graphs as ref_fuzz
import repro
from benchmarks import apps as ref_apps
from benchmarks.workloads import WORKLOADS
from repro.core import calibrate as ref_cal
from repro.core import costmodel as ref_cm
from repro.core import sim as ref_sim
from repro.launch.flopcount import count_step as ref_count_step
import repro_torch
from repro_torch import RuntimeConfig, TaskRuntime, apps, fuzz_graphs, task
from repro_torch.core import calibrate as cal
from repro_torch.core import sim
from repro_torch.core.calibrate import (CalibrationError, FIG3_LATENCY_CYCLES,
                                        FIG4_SLOWDOWN, calibrate, fit_params,
                                        granularity_sweep, validate_trends)
from repro_torch.core.costmodel import (H100Params, SCCParams, core_mc_hops,
                                        master_core_choice, worker_order)
from repro_torch.core.sim import (FlopcountCost, SimExecutor, SimTask,
                                  simulate)
from repro_torch.launch.flopcount import FlopCounter, count_step
from repro_torch.obs import InMemoryTracker

# the paper workloads cut to a few hundred tasks each (the DES runs in
# pure Python; a 1-worker run of the full 3,906 Black-Scholes tasks takes
# ~15 s), shapes and placements unchanged
WORKLOAD_SIZES = {
    "black_scholes": dict(n_options=512 * 256),
    "matmul": dict(n=512, tile=64),
    "fft": dict(n=256),
    "jacobi": dict(n=2048, iters=4),
    "cholesky": dict(n=1024),
}
_STATE = ("deps_remaining", "dependents")      # reset by simulate()


def _port_tasks(ref_tasks) -> list[SimTask]:
    """A reference task list carried into the port's ``SimTask``, field by
    field (the simulation state excepted: ``simulate`` resets it)."""
    return [SimTask(**{f.name: getattr(t, f.name)
                       for f in dataclasses.fields(t)
                       if f.name not in _STATE})
            for t in ref_tasks]


def _ref_tasks(name, fused: bool = False):
    tasks = WORKLOADS[name](**WORKLOAD_SIZES[name])
    if fused:
        # every other task inside a fused wave kernel, a third of its
        # bytes on chip: the DES's kernel_backend="pallas" charges
        for t in tasks[::2]:
            t.fused, t.onchip_bytes = True, t.mem_bytes / 3
    return tasks


# ---------------------------------------------------------------------------
# the DES, equal to the reference's
@pytest.mark.parametrize("name", sorted(WORKLOADS))
@pytest.mark.parametrize("workers", [1, 8, 43])
@pytest.mark.parametrize("managers,batch_lines", [(None, 1), (4, 1), (4, 4)])
def test_simulate_equals_reference(name, workers, managers, batch_lines):
    ref_tasks = _ref_tasks(name, fused=workers == 8)
    port_tasks = _port_tasks(ref_tasks)
    kw = dict(dep_managers=managers, dep_batch_lines=batch_lines)
    want = ref_sim.simulate(ref_tasks, workers, ref_cm.SCCParams(), **kw)
    got = simulate(port_tasks, workers, SCCParams(), **kw)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.breakdown == want.breakdown
    assert sim.sequential_time(port_tasks, SCCParams()) == \
        ref_sim.sequential_time(ref_tasks, ref_cm.SCCParams())


def _stream(rng: random.Random, homes: int, n: int):
    """A random logical descriptor stream in the ``traffic_log`` form:
    queries and releases of 1-3 slots, flush-all syncs and measured
    flushes (which the replay ignores), and the deps in each grant."""
    events, grant_deps, qid = [], {}, 0
    for _ in range(n):
        x = rng.random()
        if x < 0.06:
            events.append(("sync",))
        elif x < 0.1:
            events.append(("flush", rng.randrange(homes)))
        elif x < 0.6:
            events.append(("desc", rng.randrange(homes), "dep_query",
                           rng.randint(1, 3), qid))
            grant_deps[qid] = rng.randrange(6)
            qid += 1
        else:
            events.append(("desc", rng.randrange(homes), "release",
                           rng.randint(1, 2), None))
    return events, grant_deps


@pytest.mark.parametrize("batch_lines", [1, 2, 4])
def test_predict_dep_traffic_equals_reference(batch_lines):
    rng = random.Random(batch_lines)
    for _ in range(20):
        events, deps = _stream(rng, rng.choice([1, 2, 4]), 300)
        assert sim.predict_dep_traffic(events, batch_lines, deps) == \
            ref_sim.predict_dep_traffic(events, batch_lines, deps)
    assert sim.predict_dep_traffic([], batch_lines) == \
        ref_sim.predict_dep_traffic([], batch_lines)


def test_costmodel_equals_reference():
    assert [f.name for f in dataclasses.fields(SCCParams)] == \
        [f.name for f in dataclasses.fields(ref_cm.SCCParams)]
    assert dataclasses.asdict(SCCParams()) == \
        dataclasses.asdict(ref_cm.SCCParams())
    assert master_core_choice() == ref_cm.master_core_choice() == 16
    assert worker_order(16) == ref_cm.worker_order(16)
    p, q = SCCParams(), ref_cm.SCCParams()
    for hops in range(10):
        for conc in (1, 2, 7):
            assert p.mem_time_s(4096.0, hops, conc) == \
                q.mem_time_s(4096.0, hops, conc)
        assert p.mpb_write_s(hops) == q.mpb_write_s(hops)


def test_h100_params_hold_no_tpu_figure():
    h = H100Params()
    tpu = {float(getattr(ref_cm.TPUParams(), f.name))
           for f in dataclasses.fields(ref_cm.TPUParams)}
    figures = {float(getattr(h, f.name)) for f in dataclasses.fields(h)}
    assert not figures & tpu
    # NVIDIA's H100 SXM data sheet, dense, at 700 W
    assert (h.peak_flops_bf16, h.peak_flops_fp32, h.hbm_bw, h.nvlink_bw) == \
        (989e12, 67e12, 3.35e12, 450e9)
    terms = h.roofline_terms(989e12, 3.35e12, 450e9, chips=1)
    assert terms == {"compute_s": 1.0, "memory_s": 1.0,
                     "collective_s": 1.0}
    assert h.roofline_terms(2 * 989e12, 0, 0, chips=2)["compute_s"] == 1.0


# ---------------------------------------------------------------------------
# calibration, equal to the reference's
def test_fit_params_equals_reference():
    got, want = fit_params(), ref_cal.fit_params()
    assert dataclasses.asdict(got.params) == dataclasses.asdict(want.params)
    assert (got.fig3_max_rel_err, got.fig4_max_rel_err) == \
        (want.fig3_max_rel_err, want.fig4_max_rel_err)
    fig3 = {h: 300.0 + 20.0 * h for h in range(0, 9, 2)}
    fig4 = {c: 1.0 + 0.4 * (c - 1) for c in (1, 2, 4, 8, 16, 32)}
    assert fit_params(fig3=fig3, fig4=fig4).as_dict() == \
        ref_cal.fit_params(fig3=fig3, fig4=fig4).as_dict()


def test_calibrate_and_sweep_equal_reference():
    got, want = calibrate(), ref_cal.calibrate()
    assert got.as_dict() == want.as_dict()
    assert got.ok and want.ok
    params = fit_params().params
    assert granularity_sweep(params) == \
        ref_cal.granularity_sweep(ref_cal.fit_params().params)
    assert cal.FIG3_LATENCY_CYCLES == ref_cal.FIG3_LATENCY_CYCLES
    assert cal.FIG4_SLOWDOWN == ref_cal.FIG4_SLOWDOWN
    flat = dataclasses.replace(SCCParams(), contention_alpha=0.0)
    ref_flat = dataclasses.replace(ref_cm.SCCParams(), contention_alpha=0.0)
    assert validate_trends(flat) == ref_cal.validate_trends(ref_flat)


# ---------------------------------------------------------------------------
# the flop counter and FlopcountCost, body by body
def _cost_table(pkg, app_module, cost, **config) -> dict:
    """``{(body name, region shapes): (flops, walk bytes) | None}`` of
    every body structure the five apps spawn, from one FlopcountCost's
    cache (the reference's key and the port's carry (mode, shape, dtype)
    per footprint argument after the body)."""
    table = {}
    for name in app_module.APPS:
        fc = cost()
        rt = pkg.TaskRuntime(executor="sim", sim_cost_fn=fc, **config)
        try:
            app_module.APPS[name](rt, verify=False)
        finally:
            rt.shutdown()
        for key, counted in fc._cache.items():
            shapes = tuple(p[1] for p in key[1:]
                           if p[0] in ("In", "Out", "InOut"))
            table[(key[0].__name__, shapes)] = counted
    return table


@pytest.fixture(scope="module")
def cost_tables():
    return (_cost_table(repro_torch, apps, FlopcountCost, device="cpu"),
            _cost_table(repro, ref_apps, ref_sim.FlopcountCost))


# (port - reference) of (flops, walk bytes) per body structure at the
# apps' default sizes, and why.  Bytes differ where the walks meet other
# ops; the DES charges max(walk bytes, footprint bytes).
_DSLICE = ("dynamic_slice2d builds the window from index_select with "
           "r0 + arange(h) and c0 + arange(w) (one add per index, two "
           "clamps, two index_select, two arange) where the reference "
           "has one dynamic_slice and four scalar index ops")
_STENCIL = ("jacobi_step assembles the fixed border with two cat (bytes "
            "of every piece in and out) where the reference writes the "
            "interior with one scatter; then " + _DSLICE)
PINNED_GAPS = {
    ("_gemm", ((64, 64),) * 3): ((0.0, 0.0), "equal: mm + add"),
    ("_update", ((64, 64),) * 3): ((0.0, 0.0), "equal: mm + sub"),
    ("_trsm", ((64, 64),) * 2): ((0.0, 0.0),
                                 "equal: one triangular solve"),
    ("_potrf", ((64, 64),)): (
        (-16383.0, -237572.0),
        "jnp.linalg.cholesky symmetrizes (a + a.T) / 2 and masks the "
        "upper triangle with two iotas, a compare and a select (5 "
        "elementwise ops a tile); torch.linalg.cholesky is one op, "
        "counted as its output tile plus its 1-element info"),
    ("_price", ((512,),) * 7): (
        (0.0, -52.0),
        "equal flops; the reference's walk counts its 13 f32 scalar "
        "literals as 0-d inputs (4 bytes each), the port's counts tensors "
        "only"),
    ("_row_fft", ((32, 256),) * 4): (
        (-16384.0, -262152.0),
        "the reference counts real/imag as elementwise ops on c64 "
        "(2 x 8192 flops); in torch they are views (view_as_real, "
        "select); the reference's walk also counts the 1j literal"),
    ("transpose_tile", ((32, 256), (32, 256), (32, 32), (32, 32))): (
        (124.0, 135112.0), _DSLICE + ", twice (re and im)"),
    ("stencil", ((128, 128), (64, 64))): ((126.0, 135096.0), _STENCIL),
    ("stencil", ((128, 192), (64, 64))): ((126.0, 200120.0), _STENCIL),
    ("stencil", ((192, 128), (64, 64))): ((126.0, 168376.0), _STENCIL),
    ("stencil", ((192, 192), (64, 64))): ((126.0, 249784.0), _STENCIL),
}


def test_every_app_body_is_counted(cost_tables):
    """No body of the five apps falls back to the footprint estimate,
    Black-Scholes' operator included (counted through its plain
    version), in either package."""
    port, ref = cost_tables
    assert set(port) == set(ref) == set(PINNED_GAPS)
    assert all(v is not None for v in port.values()), port
    assert all(v is not None for v in ref.values()), ref


@pytest.mark.parametrize("key", sorted(PINNED_GAPS))
def test_body_cost_gap_is_pinned(cost_tables, key):
    port, ref = cost_tables
    (gap_flops, gap_bytes), cause = PINNED_GAPS[key]
    assert cause
    assert port[key][0] - ref[key][0] == gap_flops
    assert port[key][1] - ref[key][1] == gap_bytes


@pytest.mark.parametrize("body", ["_gemm", "_update"])
@pytest.mark.parametrize("m,k,n", [(64, 64, 64), (32, 16, 24)])
def test_gemm_bodies_count_2mnk_plus_elementwise(body, m, k, n):
    """Both packages: exactly 2MNK for the product plus MN for the
    accumulate, and the product's flops equal torch's FlopCounterMode."""
    import jax

    port_fn = getattr(apps, body).fn
    ref_fn = getattr(ref_apps, body).fn
    yk = (k, n) if body == "_gemm" else (n, k)
    shapes = ((m, n), (m, k), yk)
    want = 2.0 * m * n * k + m * n
    got = count_step(port_fn, *(torch.empty(s, device="meta")
                                for s in shapes))
    ref = ref_count_step(
        ref_fn, *(jax.ShapeDtypeStruct(s, np.float32) for s in shapes))
    assert got["flops"] == ref["flops"] == want
    assert got["bytes"] == ref["bytes"]
    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as fcm:
        port_fn(*(torch.zeros(s) for s in shapes))
    assert fcm.get_total_flops() == 2 * m * n * k


def test_fft_counts_five_n_log2_n():
    x = torch.empty(4, 64, device="meta", dtype=torch.complex64)
    c = FlopCounter()
    with c:
        torch.fft.fft(x, dim=1)
    assert c.by_op["_fft_c2c"][0] == 5.0 * 4 * 64 * 6
    r = FlopCounter()
    with r:
        torch.fft.rfft(torch.empty(4, 64, device="meta"), dim=1)
        torch.fft.irfft(torch.empty(4, 33, device="meta",
                                    dtype=torch.complex64), n=64, dim=1)
    assert r.by_op["_fft_r2c"][0] == 5.0 * 4 * 33 * 6
    assert r.by_op["_fft_c2r"][0] == 5.0 * 4 * 64 * 6


def test_layout_and_data_ops_count_as_the_reference():
    x = torch.empty(8, 16, device="meta")
    c = FlopCounter()
    with c:
        y = x.t().reshape(16, 8).permute(1, 0)[2:5].expand(2, 3, 16)
        y.to(torch.float32)
        x.to(torch.bfloat16)                       # a dtype change only
        z = torch.cat([x, x])                      # bytes only
        x.index_select(0, torch.arange(4, device="meta"))
        z.sum()                                    # one per input element
        torch.exp(x)                               # one per output element
    assert set(c.by_op) == {"cat", "arange", "index_select", "sum", "exp"}
    assert c.by_op["cat"] == [0.0, 2 * 8 * 16 * 4 * 2]
    assert c.by_op["sum"][0] == 2 * 8 * 16
    assert c.by_op["exp"] == [128.0, 128 * 4 * 2]


def test_package_operator_counts_through_its_plain_version():
    """The Black-Scholes operator has no meta implementation; the
    counter runs its plain version in its place, and the kernel wrapper
    never runs."""
    from repro_torch.kernels.black_scholes import kernel as bs_kernel
    from repro_torch.kernels.black_scholes import ops as bs_ops
    from repro_torch.kernels.black_scholes import ref as bs_ref
    xs = [torch.empty(512, device="meta") for _ in range(5)]
    before = bs_kernel.black_scholes.launches
    via_op, plain = FlopCounter(), FlopCounter()
    with via_op:
        call, put = bs_ops.black_scholes(*xs)
    with plain:
        bs_ref.black_scholes(*xs)
    assert call.shape == put.shape == (512,) and call.is_meta
    assert (via_op.flops, via_op.bytes) == (plain.flops, plain.bytes) > \
        (0.0, 0.0)
    assert bs_kernel.black_scholes.launches == before


# ---------------------------------------------------------------------------
# the five apps under executor="sim"
def _sim_run(pkg, app_module, name, **config):
    rt = pkg.TaskRuntime(executor="sim", **config)
    try:
        app_module.APPS[name](rt, verify=False)
        return rt.stats(), rt._exec
    finally:
        rt.shutdown()


# (port - reference) / reference of predicted_total_s at the apps'
# default sizes, 4 workers, kernel_backend="xla": 0 where every body
# costs the same (PINNED_GAPS), else the bodies' gaps through the DES
PREDICTED_GAP = {
    "matmul": 0.0,
    "black_scholes": -0.00022366590049478264,     # _price's 52 bytes
    "fft": 0.12822731659205933,                   # transpose_tile bytes
    "jacobi": 0.12256083294097068,                # stencil bytes
    "cholesky": -0.38655577555884746,             # _potrf's 8x fewer bytes
}


@pytest.mark.parametrize("name", sorted(apps.APPS))
def test_apps_predicted_total_matches_reference(name):
    st, ex = _sim_run(repro_torch, apps, name, device="cpu")
    ref_st, _ = _sim_run(repro, ref_apps, name)
    assert isinstance(ex, SimExecutor) and ex.last_result is not None
    assert st.predicted_total_s > 0
    gap = (st.predicted_total_s - ref_st.predicted_total_s) / \
        ref_st.predicted_total_s
    assert gap == pytest.approx(PREDICTED_GAP[name], rel=1e-9, abs=1e-15)
    for fld in ("tasks_spawned", "deps_found", "blocks_walked",
                "tile_moves"):
        assert getattr(st, fld) == getattr(ref_st, fld), fld
    assert st.kernel_dispatches is None and st.waves is None


def _staged_reasons(name, **config) -> tuple:
    trk = InMemoryTracker()
    st = apps.run_app(name, "staged", device="cpu", tracker=trk,
                      kernel_backend="pallas", **config)
    reasons = Counter(e.data["reason"] for e in
                      trk.events_of("kernel_dispatch") if e.data["reason"])
    return st, reasons


@pytest.mark.parametrize("name", sorted(apps.APPS))
def test_apps_pallas_prediction_is_what_staged_launches(name):
    st, ex = _sim_run(repro_torch, apps, name, device="cpu",
                      kernel_backend="pallas")
    ref_st, _ = _sim_run(repro, ref_apps, name, kernel_backend="pallas")
    staged, reasons = _staged_reasons(name)
    # the prediction is the port's staged executor's decision, by reason
    assert (st.kernel_dispatches, st.kernel_fallbacks) == \
        (staged.kernel_dispatches, staged.kernel_fallbacks)
    assert dict(ex.fallbacks) == dict(reasons)
    # the reference fuses every eligible group (ROADMAP queue 3)
    no_kernel = ex.fallbacks["no_kernel"]
    assert ref_st.kernel_dispatches == st.kernel_dispatches + no_kernel
    assert ref_st.kernel_fallbacks == st.kernel_fallbacks - no_kernel
    assert st.predicted_total_s > 0


def _const_cost(td):
    return 1000.0, 4096.0


@pytest.mark.parametrize("seed", fuzz_graphs.SEEDS)
def test_fuzz_seed_pallas_prediction(seed):
    """On every fuzz seed (a constant cost: the dispatch prediction does
    not depend on it), the sim predicts what the port's staged executor
    launches, by reason, and the reference's sim predicts the port's
    dispatches plus its no_kernel fallbacks.  Under "xla", where nothing
    fuses, the two packages' predicted makespans are equal; under
    "pallas" they differ by the groups only the reference fuses."""
    kw = dict(kernel_backend="pallas", sim_cost_fn=_const_cost)
    _, st = fuzz_graphs.run_case(seed, "cpu", executor="sim", **kw)
    _, ref_st = ref_fuzz.run_case(seed, executor="sim", **kw)
    trk = InMemoryTracker()
    _, staged = fuzz_graphs.run_case(seed, "cpu", kernel_backend="pallas",
                                     tracker=trk)
    reasons = Counter(e.data["reason"] for e in
                      trk.events_of("kernel_dispatch") if e.data["reason"])
    assert (st.kernel_dispatches, st.kernel_fallbacks) == \
        (staged.kernel_dispatches, staged.kernel_fallbacks)
    no_kernel = reasons["no_kernel"]
    assert ref_st.kernel_dispatches == st.kernel_dispatches + no_kernel
    assert ref_st.kernel_fallbacks == st.kernel_fallbacks - no_kernel
    assert dict(reasons) == {k: v for k, v in _fallbacks(seed).items() if v}
    _, xla = fuzz_graphs.run_case(seed, "cpu", executor="sim",
                                  sim_cost_fn=_const_cost)
    _, ref_xla = ref_fuzz.run_case(seed, executor="sim",
                                   sim_cost_fn=_const_cost)
    assert xla.predicted_total_s == ref_xla.predicted_total_s > 0


def _fallbacks(seed) -> Counter:
    """The port sim's predicted fallbacks of one seed, by reason."""
    cfg = RuntimeConfig(executor="sim", device="cpu",
                        kernel_backend="pallas", sim_cost_fn=_const_cost)
    rt = TaskRuntime(cfg)
    try:
        with rt.scope():
            arrs = {name: rt.zeros((24, 24), (8, 8), name=name)
                    for name in ("A", "B", "C")}
            arrs["M"] = rt.zeros((24, 24), (8, 8), dtype=torch.int32,
                                 name="M")
            fuzz_graphs._spawn(fuzz_graphs.generate(seed), arrs)
            rt.barrier()
        return rt._exec.fallbacks
    finally:
        rt.shutdown()


def test_sim_computes_nothing_and_launches_nothing(monkeypatch):
    """The sim runs the real program (footprints, dependence analysis)
    but no body: the outputs keep their initial values and no kernel
    wrapper or plain kernel version is called."""
    from repro_torch.kernels.black_scholes import kernel as bs_kernel
    from repro_torch.kernels.jacobi import kernel as jac_kernel
    from repro_torch.kernels.matmul import kernel as mm_kernel
    calls = []
    for mod, fn in ((mm_kernel, "matmul_batched"),
                    (mm_kernel, "tile_update_batched"),
                    (jac_kernel, "jacobi_halo_batched"),
                    (bs_kernel, "black_scholes")):
        monkeypatch.setattr(mod, fn, lambda *a, _f=fn, **k: calls.append(_f))
    rt = TaskRuntime(executor="sim", device="cpu", kernel_backend="pallas")
    C = apps.matmul_app(rt, n=128, tile=32, verify=False)
    call, put = apps.black_scholes_app(rt, verify=False)
    rt.shutdown()
    assert not calls
    assert torch.count_nonzero(C.gather()) == 0
    assert torch.count_nonzero(call.gather()) == 0
    st = rt.stats()
    assert st.tasks_spawned == 4 ** 3 + 16 and st.kernel_dispatches == 4


def test_sim_emits_sim_predict():
    trk = InMemoryTracker()
    st = apps.run_app("cholesky", "sim", device="cpu", tracker=trk)
    [ev] = trk.events_of("sim_predict")
    assert ev.data["tasks"] == st.tasks_spawned
    assert ev.data["predicted_s"] == st.predicted_total_s
    assert ev.data["sequential_s"] > ev.data["predicted_s"] > 0


def test_sharded_managers_reach_the_des():
    central = apps.run_app("matmul", "sim", device="cpu", n_workers=8)
    sharded = apps.run_app("matmul", "sim", device="cpu", n_workers=8,
                           dep_manager="sharded", dep_batch_lines=1)
    batched = apps.run_app("matmul", "sim", device="cpu", n_workers=8,
                           dep_manager="sharded", dep_batch_lines=4)
    ref = ref_apps.run_app("matmul", "sim", n_workers=8,
                           dep_manager="sharded", dep_batch_lines=4)
    assert len({central.predicted_total_s, sharded.predicted_total_s,
                batched.predicted_total_s}) == 3
    assert batched.predicted_total_s == ref.predicted_total_s


# ---------------------------------------------------------------------------
# the reference's tests/test_calibration.py, ported
@task(out="c", in_=("a", "b"))
def _pure_gemm(a, b, c=None):
    return a @ b


@task(inout="x", firstprivate="r0")
def _sliced(x, r0):
    rows = torch.as_tensor(r0).reshape(1)
    return x.index_copy(0, rows, x.index_select(0, rows) * 2.0)


@task(inout="x")
def _untraceable(x):
    # a branch on a value: a meta tensor has none
    if float(x.sum()) > 0:
        return x + 1.0
    return x - 1.0


def _first_descriptor(spawn):
    """Spawn inside a sim runtime; return (descriptor, executor)."""
    rt = TaskRuntime(RuntimeConfig(executor="sim", device="cpu"))
    try:
        with rt.scope():
            spawn(rt)
            return rt._exec.pending[0], rt._exec
    finally:
        rt.shutdown()


class TestFlopcountCost:
    def test_gemm_tile_cost_is_2mnk(self):
        M, K, N = 32, 16, 24

        def spawn(rt):
            A = rt.zeros((M, K), (M, K))
            B = rt.zeros((K, N), (K, N))
            C = rt.zeros((M, N), (M, N))
            _pure_gemm(A[0, 0], B[0, 0], C[0, 0])

        td, _ = _first_descriptor(spawn)
        flops, nbytes = FlopcountCost()(td)
        assert flops == 2.0 * M * N * K
        assert nbytes >= 4 * (M * K + K * N + M * N)

    def test_default_cost_is_flopcount(self):
        rt = TaskRuntime(RuntimeConfig(executor="sim", device="cpu"))
        try:
            assert isinstance(rt._exec.cost_fn, FlopcountCost)
        finally:
            rt.shutdown()

    def test_cost_traced_once_per_structure(self):
        fc = FlopcountCost()
        rt = TaskRuntime(RuntimeConfig(executor="sim", device="cpu"))
        try:
            with rt.scope():
                A = rt.zeros((8, 8), (4, 4))
                B = rt.zeros((8, 8), (4, 4))
                C = rt.zeros((8, 8), (4, 4))
                for i in range(2):
                    for j in range(2):
                        _pure_gemm(A[i, 0], B[0, j], C[i, j])
                costs = {fc(td) for td in rt._exec.pending}
                assert len(rt._exec.pending) == 4
                assert len(costs) == 1
                assert len(fc._cache) == 1
        finally:
            rt.shutdown()

    def test_firstprivate_values_enter_the_trace(self):
        def spawn(rt):
            X = rt.zeros((8, 8), (8, 8))
            _sliced(X[0, 0], 3)

        td, _ = _first_descriptor(spawn)
        fc = FlopcountCost()
        flops, nbytes = fc(td)
        assert flops > 0 and nbytes >= 8 * 8 * 4
        assert fc._cache[fc._key(td)] is not None

    def test_untraceable_body_falls_back_to_footprint(self):
        def spawn(rt):
            X = rt.zeros((8, 8), (8, 8))
            _untraceable(X[0, 0])

        td, _ = _first_descriptor(spawn)
        fc = FlopcountCost()
        assert fc(td) == SimExecutor._footprint_cost(td)
        assert fc._cache[fc._key(td)] is None


class TestSimMonotone:
    def _stream(self, home=0, n=64):
        return [SimTask(tid=i, flops=1e3, mem_bytes=1e6, homes=(home,))
                for i in range(n)]

    def test_sim_time_monotone_in_contention(self):
        alphas = (0.1, 0.3, 0.55, 0.9)
        times = [simulate(self._stream(), 8,
                          dataclasses.replace(SCCParams(),
                                              contention_alpha=a)).total_s
                 for a in alphas]
        assert all(b > a for a, b in zip(times, times[1:]))

    def test_sim_time_monotone_in_hop_distance(self):
        w0 = worker_order(master_core_choice())[0]
        hops = [core_mc_hops(w0, m) for m in range(4)]
        near, far = int(np.argmin(hops)), int(np.argmax(hops))
        assert hops[near] < hops[far]
        p = SCCParams()
        t_near = simulate(self._stream(home=near, n=4), 1, p).total_s
        t_far = simulate(self._stream(home=far, n=4), 1, p).total_s
        assert t_far > t_near

    def test_sim_params_reach_the_executor(self):
        slow = dataclasses.replace(SCCParams(), freq_hz=533e6 / 4)
        kw = dict(n_workers=8, device="cpu",
                  app_kwargs={"n": 128, "tile": 32})
        s_fast = apps.run_app("matmul", "sim", **kw)
        s_slow = apps.run_app("matmul", "sim", sim_params=slow, **kw)
        assert s_slow.predicted_total_s > 2.0 * s_fast.predicted_total_s


class TestSimAppTrends:
    def test_gemm_app_striped_beats_single(self):
        kw = {"app_kwargs": {"n": 256, "tile": 64}, "n_workers": 16,
              "device": "cpu"}
        striped = apps.run_app("matmul", "sim", placement="striped", **kw)
        single = apps.run_app("matmul", "sim", placement="single", **kw)
        assert striped.predicted_total_s < single.predicted_total_s

    def test_granularity_sweep_has_interior_optimum(self):
        rows = granularity_sweep(fit_params().params)
        best = max(range(len(rows)), key=lambda i: rows[i]["speedup"])
        assert 0 < best < len(rows) - 1


class TestCalibrate:
    def test_fit_recovers_anchor_shape(self):
        r = fit_params()
        assert 10 < r.params.dram_hop_cycles < 25
        assert 200 < r.params.dram_base_cycles < 300
        assert 0.4 < r.params.contention_alpha < 0.7
        assert r.fig3_max_rel_err < 0.05
        assert r.fig4_max_rel_err < 0.05

    def test_fit_preserves_unfitted_constants(self):
        base = dataclasses.replace(SCCParams(), flush_cycles=1234.0)
        assert fit_params(base).params.flush_cycles == 1234.0

    def test_calibrate_validates_trends(self):
        r = calibrate()
        assert r.ok
        assert set(r.checks) == {
            "fig3_latency_monotone_in_hops",
            "fig4_time_monotone_in_contention",
            "striped_beats_single",
            "granularity_interior_optimum",
        }
        assert all(r.as_dict()["checks"].values())

    def test_calibrate_raises_when_a_finding_breaks(self):
        broken = dataclasses.replace(SCCParams(), spawn_base_cycles=5e6,
                                     schedule_cycles=5e5)
        with pytest.raises(CalibrationError, match="no longer reproduce"):
            calibrate(base=broken)

    def test_validate_trends_flags_disabled_contention(self):
        flat = dataclasses.replace(SCCParams(), contention_alpha=0.0)
        checks = validate_trends(flat)
        assert not checks["striped_beats_single"]
        assert not checks["fig4_time_monotone_in_contention"]

    def test_anchor_tables_are_well_formed(self):
        assert sorted(FIG3_LATENCY_CYCLES) == [0, 2, 4, 6, 8]
        assert FIG4_SLOWDOWN[1] == 1.0
        assert all(FIG4_SLOWDOWN[a] < FIG4_SLOWDOWN[b]
                   for a, b in zip(sorted(FIG4_SLOWDOWN),
                                   sorted(FIG4_SLOWDOWN)[1:]))
