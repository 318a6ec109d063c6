"""The paper's five apps on repro_torch against the same apps on repro.

Both packages run the same programs on the same numpy-seeded inputs
(``benchmarks/apps.py`` and ``repro_torch.apps``, seeds 0..4), the port
on the CPU with ``device="cpu"``:

* structure count for count: every task's dependence set, the wave
  schedules, ``deps_found``/``blocks_walked``/``waves``/
  ``grouped_dispatches``;
* outputs within each app's own ``verify=`` tolerance;
* under ``kernel_backend="pallas"``, every group accounted once, the
  ``kernel_dispatch`` events of the registered bodies (``_gemm``,
  ``_update``, ``stencil``) equal to the reference's, and every other
  fallback reason the reference's own or ``no_kernel``;
* the port's sequential and staged executors agreeing.
"""
import numpy as np
import pytest
import torch

from benchmarks import apps as ref_apps
from repro import RuntimeConfig as RefConfig, TaskRuntime as RefRuntime
from repro.obs import InMemoryTracker as RefTracker
from repro_torch import RuntimeConfig, TaskRuntime, apps
from repro_torch.interop import config_from_reference
from repro_torch.obs import InMemoryTracker

SIZES = {
    "black_scholes": dict(n_options=2048, task_options=256),
    "matmul": dict(n=64, tile=16),
    "fft": dict(n=64, row_block=16, tile=16),
    "jacobi": dict(n=64, tile=16, iters=2),
    "cholesky": dict(n=64, tile=16),
}
# each app's own verify= tolerance (rtol, atol)
TOLERANCE = {
    "black_scholes": (1e-5, 1e-3),
    "matmul": (2e-4, 2e-4),
    "fft": (2e-2, 2e-1),
    "jacobi": (1e-5, 1e-5),
    "cholesky": (2e-2, 2e-2),
}
REGISTERED = {"_gemm", "_update", "stencil"}
APP_NAMES = sorted(SIZES)

_RUNS: dict = {}


def _gathered(out) -> list:
    arrays = out if isinstance(out, tuple) else (out,)
    gathered = [a.gather() for a in arrays]
    return [np.asarray(g.cpu() if isinstance(g, torch.Tensor) else g)
            for g in gathered]


def _run(package: str, name: str, executor: str = "staged",
         backend: str = "xla") -> dict:
    """One app run, recorded: per-task dependence sets at spawn, the wave
    schedule, stats, tracker events and gathered outputs."""
    key = (package, name, executor, backend)
    if key in _RUNS:
        return _RUNS[key]
    fields = dict(executor=executor, kernel_backend=backend)
    if package == "ref":
        trk = RefTracker()
        rt = RefRuntime(RefConfig(**fields, tracker=trk))
        program = ref_apps.APPS[name]
    else:
        trk = InMemoryTracker()
        cfg = config_from_reference({**RefConfig(**fields).__dict__,
                                     "device": "cpu"})
        rt = TaskRuntime(cfg.replace(tracker=trk))
        program = apps.APPS[name]
    spawns, waves = [], []
    on_spawn = rt._exec.on_spawn

    def record_spawn(td, ready):
        spawns.append((td.tid, td.name, tuple(p.tid for p in td.preds),
                       ready))
        on_spawn(td, ready)

    rt._exec.on_spawn = record_spawn
    if executor == "staged":
        wavefronts = rt._exec._wavefronts

        def record_waves(tasks):
            out = wavefronts(tasks)
            waves.extend([td.tid for td in w] for w in out)
            return out

        rt._exec._wavefronts = record_waves
    out = program(rt, **SIZES[name])
    stats = rt.stats()
    rt.shutdown()
    run = _RUNS[key] = dict(spawns=spawns, waves=waves, stats=stats,
                            events=trk.events, out=_gathered(out))
    return run


def _close(name, got, want):
    rtol, atol = TOLERANCE[name]
    if name == "cholesky":
        got, want = [np.tril(g) for g in got], [np.tril(w) for w in want]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol)


# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", APP_NAMES)
def test_dependences_and_waves_match_reference(name):
    ref, port = _run("ref", name), _run("port", name)
    assert port["spawns"] == ref["spawns"]
    assert port["waves"] == ref["waves"]
    for fld in ("tasks_spawned", "deps_found", "blocks_walked", "waves",
                "grouped_dispatches"):
        assert getattr(port["stats"], fld) == getattr(ref["stats"], fld), fld


@pytest.mark.parametrize("name", APP_NAMES)
@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_outputs_match_reference(name, backend):
    _close(name, _run("port", name, backend=backend)["out"],
           _run("ref", name, backend=backend)["out"])


@pytest.mark.parametrize("name", APP_NAMES)
def test_kernel_dispatch_events_match_reference(name):
    ref, port = _run("ref", name, backend="pallas"), \
        _run("port", name, backend="pallas")
    kd = [e.data for e in ref["events"] if e.kind == "kernel_dispatch"]
    pd = [e.data for e in port["events"] if e.kind == "kernel_dispatch"]
    dispatches = [e for e in port["events"] if e.kind == "dispatch"]
    # every group accounted exactly once: fused or a named fallback
    assert len(pd) == len(dispatches) == len(kd)
    s = port["stats"]
    assert s.kernel_dispatches + s.kernel_fallbacks == len(pd)
    assert s.kernel_dispatches == sum(d["backend"] == "pallas" for d in pd)
    for r, p in zip(kd, pd):
        assert (p["wave"], p["fn"], p["tasks"]) == \
            (r["wave"], r["fn"], r["tasks"])
        if p["fn"] in REGISTERED:
            assert (p["backend"], p["reason"]) == \
                (r["backend"], r["reason"])
        elif r["backend"] == "pallas":
            assert (p["backend"], p["reason"]) == ("xla", "no_kernel")
        else:
            assert p["reason"] == r["reason"]


@pytest.mark.parametrize("name", APP_NAMES)
def test_port_sequential_and_staged_agree(name):
    """Bit for bit on the CPU, as in the reference: there the wave
    kernels' plain versions repeat the vmap path's arithmetic."""
    seq = _run("port", name, executor="sequential")
    for backend in ("xla", "pallas"):
        staged = _run("port", name, backend=backend)
        for s, g in zip(seq["out"], staged["out"]):
            np.testing.assert_array_equal(g, s)
    assert seq["spawns"] == _run("ref", name, executor="sequential")["spawns"]


def test_run_app_self_verifies_on_cpu():
    stats = apps.run_app("jacobi", kernel_backend="pallas", device="cpu",
                         app_kwargs=SIZES["jacobi"])
    assert stats.kernel_dispatches == stats.grouped_dispatches == 8
    assert stats.kernel_fallbacks == 0


def test_wave_kernel_registry_covers_the_three_bodies():
    from repro_torch.core import wavekernel
    assert wavekernel.wave_kernel_for(apps._gemm) is not None
    assert wavekernel.wave_kernel_for(apps._update) is not None
    assert wavekernel.wave_kernel_for(apps._potrf) is None
    with TaskRuntime(RuntimeConfig(executor="staged", device="cpu",
                                   kernel_backend="pallas")) as rt:
        apps.jacobi_app(rt, **SIZES["jacobi"])
        assert rt.stats().kernel_dispatches == 8


def test_gc_timer_counts_collections():
    import gc
    from repro_torch.profile_apps import GCTimer
    with GCTimer() as timer:
        gc.collect()
    assert timer.collections[2] >= 1
    assert timer.seconds > 0.0
    assert timer not in gc.callbacks
