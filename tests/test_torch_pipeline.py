"""repro_torch.core.pipeline against the JAX package's, on the CPU.

The 1F1B timetable comes out of the port's ``DependenceAnalyzer`` over
the same declared footprints, so it must equal the reference's entry for
entry; ``pipeline_step`` runs it on 4 logical devices of the CPU, each
task on its stage's device with the stage hops as counted copies, and
its weight gradients are held within 1e-5 of ``jax.grad`` of the
sequential model and of the reference's own ``pipeline_step`` on 4
forced host devices (one subprocess: ``XLA_FLAGS`` must be set before
JAX is imported).
"""
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.core import pipeline as ref_pipeline
from repro_torch import dist
from repro_torch.core import pipeline
from repro_torch.core.pipeline import (PipeTask, derive_pipeline_schedule,
                                       pipeline_step, schedule_table)

ROOT = pathlib.Path(__file__).resolve().parent.parent
CASES = [(2, 4), (3, 5), (4, 6), (4, 8), (8, 8)]
S, M, B, D = 4, 8, 2, 16          # the reference test's pipeline_step


def _strs(table):
    return [[repr(t) if t else None for t in row] for row in table]


# ---------------------------------------------------------------------------
# the timetable, entry for entry
@pytest.mark.parametrize("n_stages,n_micro", CASES)
def test_schedule_equals_the_reference(n_stages, n_micro):
    got = derive_pipeline_schedule(n_stages, n_micro)
    want = ref_pipeline.derive_pipeline_schedule(n_stages, n_micro)
    assert _strs(got) == _strs(want)
    assert [[t and (t.kind, t.stage, t.micro) for t in row] for row in got] \
        == [[t and (t.kind, t.stage, t.micro) for t in row] for row in want]
    assert schedule_table(got) == ref_pipeline.schedule_table(want)


def test_pipe_task_is_the_reference_s():
    t = PipeTask("B", 2, 5)
    assert repr(t) == repr(ref_pipeline.PipeTask("B", 2, 5)) == "B2.5"
    assert t == PipeTask("B", 2, 5) and hash(t) == hash(PipeTask("B", 2, 5))
    with pytest.raises(AttributeError):
        t.micro = 1
    assert pipeline.__all__ == ref_pipeline.__all__


# the four cases of tests/test_pipeline.py, on the port's tables
def test_optimal_clock_count():
    """Greedy backward-first scheduling reaches the 1F1B bound:
    2*M + 2*(S-1) clocks."""
    for s, m in ((2, 4), (4, 8), (8, 8)):
        assert len(derive_pipeline_schedule(s, m)) == 2 * m + 2 * (s - 1)


def test_dependencies_respected():
    table = derive_pipeline_schedule(4, 6)
    seen = set()
    for row in table:
        fired = [t for t in row if t]
        for t in fired:
            if t.kind == "F" and t.stage > 0:
                assert PipeTask("F", t.stage - 1, t.micro) in seen
            if t.kind == "B":
                assert PipeTask("F", t.stage, t.micro) in seen
                if t.stage < 3:
                    assert PipeTask("B", t.stage + 1, t.micro) in seen
        seen.update(fired)
    assert len(seen) == 2 * 4 * 6


def test_weight_grad_serialized_per_stage():
    """INOUT dW[s] serializes each stage's backwards, in microbatch
    order."""
    last_micro = {s: -1 for s in range(3)}
    for row in derive_pipeline_schedule(3, 5):
        for t in row:
            if t and t.kind == "B":
                assert t.micro == last_micro[t.stage] + 1
                last_micro[t.stage] = t.micro


def test_steady_state_is_1f1b():
    """The last stage alternates F, B strictly."""
    table = derive_pipeline_schedule(4, 8)
    assert "".join(row[3].kind for row in table if row[3]) == "FB" * 8


class _Ops(TorchDispatchMode):
    """Every aten op dispatched inside, with its outputs' devices."""

    def __init__(self):
        super().__init__()
        self.devices = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        outs = out if isinstance(out, (tuple, list)) else (out,)
        self.devices += [(str(func), o.device) for o in outs
                         if isinstance(o, torch.Tensor)]
        return out


def test_schedule_allocates_nothing_on_a_real_device(monkeypatch):
    made = []
    real = pipeline.BlockArray

    def spy(*args, **kw):
        ba = real(*args, **kw)
        made.append(ba)
        return ba

    monkeypatch.setattr(pipeline, "BlockArray", spy)
    with _Ops() as ops:
        table = derive_pipeline_schedule(4, 8)
    assert len(table) == 22
    assert [ba.name for ba in made] == ["A", "G", "dW"]
    assert all(ba.device.type == "meta" for ba in made)
    assert all(not list(ba.store.indices()) for ba in made)
    assert all(dev.type == "meta" for _, dev in ops.devices), ops.devices


# ---------------------------------------------------------------------------
# pipeline_step on 4 logical devices of the CPU
def _inputs():
    rng = np.random.default_rng(0)
    ws = (rng.standard_normal((S, D, D)) * D ** -0.5).astype(np.float32)
    xs = rng.standard_normal((M, B, D)).astype(np.float32)
    return ws, xs


def _fwd(w, x):
    return torch.tanh(x @ w)


def _bwd(w, x, g):
    _, vjp = torch.func.vjp(_fwd, w, x)
    gw, gx = vjp(g)
    return gx, gw


def _mesh(n=S):
    return dist.Mesh(dist.logical_devices(n, "cpu"), ("stage",))


def _jax_sequential(ws, xs):
    def full(ws_, x):
        h = x
        for s in range(S):
            h = jnp.tanh(h @ ws_[s])
        return h.sum()
    return np.asarray(sum(jax.grad(full)(jnp.asarray(ws), jnp.asarray(xs[m]))
                          for m in range(M)))


def test_pipeline_step_matches_jax_grad_of_the_sequential_model():
    ws, xs = _inputs()
    pipeline_step.hops = pipeline_step.hopped_bytes = 0
    dw = pipeline_step(_fwd, _bwd, torch.from_numpy(ws),
                       torch.from_numpy(xs), mesh=_mesh(),
                       stage_axis="stage", n_stages=S)
    assert tuple(dw.shape) == (S, D, D) and dw.dtype == torch.float32
    np.testing.assert_allclose(dw.numpy(), _jax_sequential(ws, xs),
                               rtol=1e-5, atol=1e-5)
    # F outputs forward and B input gradients back: 2 (S-1) M hops
    assert pipeline_step.hops == 2 * (S - 1) * M
    assert pipeline_step.hopped_bytes == 2 * (S - 1) * M * B * D * 4


def test_pipeline_step_with_autograd_bodies_and_a_dict_tree():
    """``params`` as a dict tree, ``stage_bwd`` through
    ``torch.autograd.grad``: the same gradients as the tensor form."""
    ws, xs = _inputs()
    bias = np.random.default_rng(3).standard_normal((S, D)) \
        .astype(np.float32)

    def fwd(p, x):
        return torch.tanh(x @ p["w"] + p["b"])

    def bwd(p, x, g):
        p = {k: v.detach().requires_grad_(True) for k, v in p.items()}
        x = x.detach().requires_grad_(True)
        with torch.enable_grad():
            gx, gw, gb = torch.autograd.grad(fwd(p, x), [x, p["w"], p["b"]],
                                             g)
        return gx, {"w": gw, "b": gb}

    params = {"w": torch.from_numpy(ws), "b": torch.from_numpy(bias)}
    dw = pipeline_step(fwd, bwd, params, torch.from_numpy(xs), mesh=_mesh(),
                       stage_axis="stage", n_stages=S)

    seq = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    for m in range(M):
        h = torch.from_numpy(xs[m])
        for s in range(S):
            h = torch.tanh(h @ seq["w"][s] + seq["b"][s])
        h.sum().backward()
    for k in params:
        torch.testing.assert_close(dw[k], seq[k].grad, rtol=1e-5, atol=1e-5)


def test_pipeline_step_result_on_the_callers_device_and_stages_on_theirs():
    """A deviation by design: the reference leaves the gradient stack
    sharded over the stage axis; the port assembles it on the device of
    ``params``.  Each task runs on its stage's logical device: every
    received activation and gradient is a copy of its own."""
    ws, xs = _inputs()
    mesh = _mesh()
    seen = []

    def fwd(w, x):
        seen.append(x)               # kept alive: no storage is reused
        return _fwd(w, x)

    micros = torch.from_numpy(xs)
    dw = pipeline_step(fwd, _bwd, torch.from_numpy(ws), micros, mesh=mesh,
                       stage_axis="stage", n_stages=S)
    assert dw.device == torch.device("cpu")
    # the stage-0 inputs share micro_inputs' storage; every other stage's
    # input is a hop, a storage of its own
    ptrs = [x.untyped_storage().data_ptr() for x in seen]
    own = micros.untyped_storage().data_ptr()
    assert len(seen) == S * M and ptrs.count(own) == M
    assert len(set(ptrs) - {own}) == (S - 1) * M


def test_pipeline_step_on_a_two_axis_mesh_uses_the_stage_axis():
    ws, xs = _inputs()
    devs = np.empty(2 * S, dtype=object)
    devs[:] = dist.logical_devices(2 * S, "cpu")
    mesh = dist.Mesh(devs.reshape(2, S), ("data", "stage"))
    dw = pipeline_step(_fwd, _bwd, torch.from_numpy(ws), torch.from_numpy(xs),
                       mesh=mesh, stage_axis="stage", n_stages=S)
    np.testing.assert_allclose(dw.numpy(), _jax_sequential(ws, xs),
                               rtol=1e-5, atol=1e-5)


def test_pipeline_step_refuses_a_mesh_that_does_not_fit():
    ws, xs = _inputs()
    args = (_fwd, _bwd, torch.from_numpy(ws), torch.from_numpy(xs))
    with pytest.raises(ValueError, match="no axis"):
        pipeline_step(*args, mesh=_mesh(), stage_axis="pod", n_stages=S)
    with pytest.raises(ValueError, match="params stack 4 stages"):
        pipeline_step(*args, mesh=_mesh(3), stage_axis="stage", n_stages=3)
    with pytest.raises(ValueError, match="4 stages on a 'stage' axis of 2"):
        pipeline_step(*args, mesh=_mesh(2), stage_axis="stage", n_stages=S)


_REFERENCE = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
sys.path.insert(0, sys.argv[1])
import jax, jax.numpy as jnp, numpy as np
import repro
from repro.core.pipeline import pipeline_step

data = np.load(sys.argv[2])
ws, xs = jnp.asarray(data["ws"]), jnp.asarray(data["xs"])
mesh = jax.make_mesh((4,), ("stage",),
                     axis_types=(jax.sharding.AxisType.Auto,))

def fwd(w, x):
    return jnp.tanh(x @ w)

def bwd(w, x, g):
    _, vjp = jax.vjp(fwd, w, x)
    gw, gx = vjp(g)
    return gx, gw

dw = jax.jit(lambda w, x: pipeline_step(fwd, bwd, w, x, mesh=mesh,
                                        stage_axis="stage", n_stages=4))(
    ws, xs)
np.save(sys.argv[3], np.asarray(dw))
"""


def test_pipeline_step_matches_the_reference_on_4_host_devices(tmp_path):
    ws, xs = _inputs()
    np.savez(tmp_path / "in.npz", ws=ws, xs=xs)
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run(
        [sys.executable, "-c", _REFERENCE, str(ROOT / "src"),
         str(tmp_path / "in.npz"), str(tmp_path / "dw.npy")],
        capture_output=True, text=True, timeout=240, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    want = np.load(tmp_path / "dw.npy")
    got = pipeline_step(_fwd, _bwd, torch.from_numpy(ws), torch.from_numpy(xs),
                        mesh=_mesh(), stage_axis="stage", n_stages=S)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
