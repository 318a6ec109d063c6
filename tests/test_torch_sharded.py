"""repro_torch's sharded executor and mesh layer against repro's, on the CPU.

The port of ``tests/test_sharded.py`` (plus the ``sharded_mesh`` case of
``tests/test_wavekernel.py`` and the sharding rules of
``tests/test_substrate.py``):

* placement -> devices: ``device_assignment``, ``home_histogram`` and
  ``home_sharding`` (to its docstring: the block axis over every mesh
  axis when the count divides, else replicated);
* owner-computes accounting, the no-mesh fallback (the staged path, wave
  kernels included), the per-device ``vmap`` dispatch under a mesh,
  firstprivate values on the split task axis, region-scoped waits;
* the same task programs (:func:`run_programs`: striped gemm over 4 homes
  and over one home per device, an uneven 5-task wave, the owner
  override with and without the tracker feeding it, the wave backend
  under a mesh, firstprivate values, Cholesky, and the five apps) on both
  packages, held count for count — ``cross_home_bytes``,
  ``local_home_bytes``, ``tile_moves``, ``bytes_moved``, ``bytes_staged``,
  ``sharded_dispatches``, ``owner_overrides``, dispatch modes, fallbacks
  by reason and every tile's device — on 1 device in this process (with
  and without ``single_device_mesh``), and on 2 and 4 devices: the
  reference on XLA's forced host devices in one subprocess per count
  (this file run as a script), the port on as many logical CPU devices.
  Outputs are bit for bit the port's sequential run and within
  1e-5 + 1e-5·|x| of ``repro``'s (XLA contracts ``c + a @ b`` into fused
  multiply-adds that torch rounds apart);
* the sharding rules leaf for leaf against the reference's on the dense
  architectures, on the port's mesh.
"""
from __future__ import annotations

import contextlib
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent

RTOL = ATOL = 1e-5

#: the stats the two packages must agree on, count for count
STAT_FIELDS = ("cross_home_bytes", "local_home_bytes", "tile_moves",
               "bytes_moved", "bytes_staged", "sharded_dispatches",
               "owner_overrides", "grouped_dispatches", "waves",
               "tasks_spawned", "deps_found")

#: the five apps at the sizes of tests/test_torch_depman.py
APP_SIZES = {
    "black_scholes": {"n_options": 2048, "task_options": 256},
    "matmul": {"n": 128, "tile": 32},
    "fft": {"n": 64, "row_block": 16, "tile": 16},
    "jacobi": {"n": 128, "tile": 32, "iters": 2},
    "cholesky": {"n": 128, "tile": 32},
}


# ---------------------------------------------------------------------------
# the task programs, one definition for both packages
def _gemm_body(c, a, b):
    return c + a @ b


def _avg_body(halo, dest=None):
    return halo[:4] * 0.5 + halo[4:] * 0.5


def _affine_body(x, k, y=None):
    return x * k


def _side(pkg: str, ndev: int):
    """What one package needs to run :func:`run_programs`."""
    if pkg == "repro":
        import jax
        from repro import TaskRuntime, dist, task
        from repro.kernels.cholesky import ops as chol
        from repro.obs import InMemoryTracker
        sys.path.insert(0, str(ROOT))
        from benchmarks.apps import run_app

        def make_mesh():
            return jax.sharding.Mesh(
                np.asarray(jax.devices()[:ndev]).reshape(ndev), ("data",))
        return dict(TaskRuntime=TaskRuntime, dist=dist, task=task,
                    chol=chol, Tracker=InMemoryTracker, run_app=run_app,
                    make_mesh=make_mesh, cfg={}, numpy=np.asarray)
    from repro_torch import TaskRuntime, dist, task
    from repro_torch.apps import run_app
    from repro_torch.kernels.cholesky import ops as chol
    from repro_torch.launch.mesh import make_mesh as port_mesh
    from repro_torch.obs import InMemoryTracker

    def make_mesh():
        return port_mesh((ndev,), ("data",),
                         devices=dist.logical_devices(ndev, "cpu"))
    return dict(TaskRuntime=TaskRuntime, dist=dist, task=task, chol=chol,
                Tracker=InMemoryTracker, run_app=run_app,
                make_mesh=make_mesh, cfg={"device": "cpu"},
                numpy=lambda t: t.cpu().numpy())


def _stats(rt) -> dict:
    s = rt.stats()
    return {f: getattr(s, f) for f in STAT_FIELDS}


def _trace(trk) -> dict:
    """Dispatch modes in order, and groups by kernel-dispatch decision."""
    if trk is None:
        return {}
    reasons: dict = {}
    for e in trk.events_of("kernel_dispatch"):
        key = e.data["reason"] or "fused"
        reasons[key] = reasons.get(key, 0) + 1
    return dict(modes=[e.data["mode"] for e in trk.events_of("dispatch")],
                reasons=reasons)


def _tiles(*arrays) -> dict:
    """Each tile's device id (None: uncommitted), by array and index."""
    out = {}
    for ba in arrays:
        for idx in ba.block_indices():
            dev = ba.tile_device(idx)
            out[f"{ba.name}{list(idx)}"] = None if dev is None else dev.id
    return out


def run_programs(pkg: str, ndev: int, mesh: bool = True,
                 executor: str = "sharded") -> dict:
    """Run every program on ``pkg`` over ``ndev`` devices (under a mesh of
    them when ``mesh``) and return, per program, its stats before the
    read-back, the outputs, dispatch modes, fallbacks by reason and tile
    locations — JSON-able, so the reference's can cross a process."""
    S = _side(pkg, ndev)
    task, np_of = S["task"], S["numpy"]
    gemm = task(inout="c", in_=("a", "b"))(_gemm_body)
    avg = task(in_="halo", out="dest")(_avg_body)
    affine = task(in_="x", out="y", firstprivate="k")(_affine_body)
    potrf = task(inout="a")(lambda a: S["chol"].potrf(a))
    trsm = task(in_="l", inout="a")(lambda l, a: S["chol"].trsm(l, a))
    update = task(inout="c", in_=("x", "y"))(
        lambda c, x, y: S["chol"].update(c, x, y))
    rng = np.random.default_rng(0)
    a128 = rng.standard_normal((128, 128), dtype=np.float32)
    b128 = rng.standard_normal((128, 128), dtype=np.float32)
    a64, b64 = a128[:64, :64].copy(), b128[:64, :64].copy()
    x24 = rng.standard_normal((24, 4), dtype=np.float32)
    m = rng.standard_normal((128, 128)).astype(np.float32)
    spd = m @ m.T + 128 * np.eye(128, dtype=np.float32)

    def run(name, body, tracked=True, **kw):
        trk = S["Tracker"]() if tracked else None
        rt = S["TaskRuntime"](executor=executor, tracker=trk, **S["cfg"],
                              **kw)
        try:
            with rt.scope():
                arrays = body(rt)
                rt.barrier()
                stats = _stats(rt)
                out = {ba.name: np_of(ba.gather()).tolist()
                       for ba in arrays}
            results[name] = dict(stats=stats, after_gather=_stats(rt),
                                 out=out, tiles=_tiles(*arrays),
                                 **_trace(trk))
        finally:
            rt.shutdown()

    def gemm_prog(n, tile, a, b):
        def body(rt):
            g = n // tile
            A = rt.from_array(a, (tile, tile), name="A")
            B = rt.from_array(b, (tile, tile), name="B")
            C = rt.zeros((n, n), (tile, tile), name="C")
            for i in range(g):
                for j in range(g):
                    for k in range(g):
                        gemm(C[i, j], A[i, k], B[k, j])
            return A, B, C
        return body

    def uneven(rt):
        X = rt.from_array(x24, (4, 4), name="X")    # 6 blocks
        Y = rt.zeros((20, 4), (4, 4), name="Y")
        for i in range(5):                          # 5 % 4 != 0
            avg(X[i:i + 2, 0], Y[i, 0])
        return X, Y

    def firstprivate(rt):
        X = rt.from_array(x24[:16].repeat(4, 1), (4, 4), name="X")
        Y = rt.zeros((16, 16), (4, 4), name="Y")
        for n, (i, j) in enumerate((i, j) for i in range(4)
                                   for j in range(4)):
            affine(X[i, j], float(n), Y[i, j])
        return X, Y

    def cholesky(rt):
        A = rt.from_array(spd, (32, 32), name="Chol")
        for k in range(4):
            potrf(A[k, k])
            for i in range(k + 1, 4):
                trsm(A[k, k], A[i, k])
            for i in range(k + 1, 4):
                for j in range(k + 1, i + 1):
                    update(A[i, j], A[i, k], A[j, k])
        return (A,)

    results: dict = {}
    ctx = S["dist"].use_mesh(S["make_mesh"]()) if mesh \
        else contextlib.nullcontext()
    with ctx:
        for homes in sorted({4, ndev}):
            run(f"gemm_h{homes}", gemm_prog(128, 32, a128, b128),
                placement="striped", n_controllers=homes)
        run("uneven", uneven, placement="striped", n_controllers=4)
        run("override", gemm_prog(64, 16, a64, b64), tracked=False,
            placement="single", owner_skew_threshold=1.5)
        run("override_tracked", gemm_prog(64, 16, a64, b64),
            placement="single", owner_skew_threshold=1.5)
        run("override_striped", gemm_prog(64, 16, a64, b64),
            placement="striped", owner_skew_threshold=1.5)
        run("pallas", gemm_prog(64, 16, a64, b64), placement="striped",
            kernel_backend="pallas")
        run("firstprivate", firstprivate)
        run("cholesky", cholesky, placement="striped_diag")
        if executor == "sharded":
            for app, size in APP_SIZES.items():
                trk = S["Tracker"]()
                st = S["run_app"](app, executor, app_kwargs=size,
                                  tracker=trk, **S["cfg"])
                results[f"app_{app}"] = dict(
                    stats={f: getattr(st, f) for f in STAT_FIELDS},
                    **_trace(trk))
    return results


# ---------------------------------------------------------------------------
# The rest is the test suite proper; run as a script, this file prints the
# reference's results instead (``python tests/test_torch_sharded.py N``,
# with XLA_FLAGS=--xla_force_host_platform_device_count=N set).
if __name__ == "__main__":
    sys.path.insert(0, str(ROOT / "src"))
    print(json.dumps(run_programs("repro", int(sys.argv[1]))))
    sys.exit(0)

import jax  # noqa: E402

import repro  # noqa: E402
from repro import dist as ref_dist  # noqa: E402
from repro.core import placement as ref_placement  # noqa: E402
from repro.core.blocks import BlockArray as RefBlockArray  # noqa: E402
from repro_torch import (RuntimeConfig, TaskRuntime, dist,  # noqa: E402
                         task)
from repro_torch.core.blocks import BlockArray  # noqa: E402
from repro_torch.core.placement import (assign_homes,  # noqa: E402
                                        device_assignment, home_histogram,
                                        home_sharding)
from repro_torch.core.sharded import ShardedExecutor, owner_home  # noqa
from repro_torch.launch.mesh import make_mesh  # noqa: E402


def cpu_mesh(n: int = 1, axes=("data",), shape=None):
    shape = shape or (n,)
    return make_mesh(shape, axes,
                     devices=dist.logical_devices(int(np.prod(shape)), "cpu"))


@task(inout="c", in_=("a", "b"))
def _gemm(c, a, b):
    return c + a @ b


@task(inout="x")
def _bump(x):
    return x + 1.0


def _gemm_program(rt, a, b, tile=32):
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
        return C.gather().numpy()


def _rt(**kw) -> TaskRuntime:
    return TaskRuntime(RuntimeConfig(device="cpu", **kw))


# ---------------------------------------------------------------------------
class TestMesh:
    def test_logical_devices_share_one_torch_device(self):
        devs = dist.logical_devices(4, "cpu")
        assert [d.id for d in devs] == [0, 1, 2, 3]
        assert {d.torch_device for d in devs} == {torch.device("cpu")}
        assert len(set(devs)) == 4

    def test_mesh_shape_and_flat_order(self):
        mesh = cpu_mesh(shape=(2, 3), axes=("data", "model"))
        assert mesh.shape == {"data": 2, "model": 3}
        assert mesh.axis_names == ("data", "model")
        assert [d.id for d in mesh.devices.flat] == list(range(6))
        assert mesh.torch_devices == (torch.device("cpu"),)

    @pytest.mark.parametrize("shape,axes", [((4,), ("data",)),
                                            ((2, 2), ("data", "model"))])
    def test_task_axis_splits_in_flat_order(self, shape, axes):
        """The split ``_sharded_stack`` reads: contiguous chunks of the
        task axis in ``mesh.devices.flat`` order."""
        mesh = cpu_mesh(shape=shape, axes=axes)
        s = dist.NamedSharding(mesh, dist.PartitionSpec(axes))
        got = [(d.id, idx[0].indices(8)[:2])
               for d, idx in s.devices_indices_map((8,)).items()]
        assert got == [(0, (0, 2)), (1, (2, 4)), (2, (4, 6)), (3, (6, 8))]

    def test_partition_spec_normalizes_like_jax(self):
        P, RefP = dist.PartitionSpec, jax.sharding.PartitionSpec
        for parts in [(("data",),), (("data", "model"), None), (None,),
                      ("model", ("data",))]:
            assert tuple(P(*parts)) == tuple(RefP(*parts))

    def test_sharding_rejects_what_it_cannot_split(self):
        mesh = cpu_mesh(4)
        s = dist.NamedSharding(mesh, dist.PartitionSpec("data"))
        with pytest.raises(ValueError, match="does not split"):
            s.devices_indices_map((6,))
        with pytest.raises(ValueError, match="lacks"):
            dist.NamedSharding(mesh, dist.PartitionSpec("model"))
        replicated = dist.NamedSharding(mesh, dist.PartitionSpec())
        assert all(idx == (slice(None),) for idx in
                   replicated.devices_indices_map((6,)).values())

    def test_make_mesh_raises_with_too_few_devices(self):
        with pytest.raises(ValueError, match="needs 4 devices"):
            make_mesh((4,), ("data",),
                      devices=dist.logical_devices(2, "cpu"))
        # more devices than asked for: the first ones, as jax.make_mesh
        mesh = make_mesh((2,), ("data",),
                         devices=dist.logical_devices(3, "cpu"))
        assert [d.id for d in mesh.devices.flat] == [0, 1]

    def test_entry_points_default_to_cuda(self, monkeypatch):
        """With no device named, the mesh builders ask for the card and
        raise without it; nothing falls back to the CPU by itself."""
        from repro_torch.launch import mesh as mesh_mod
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        for call in (dist.single_device_mesh, dist.local_devices,
                     lambda: dist.logical_devices(2),
                     lambda: mesh_mod.make_mesh((1,), ("data",)),
                     mesh_mod.make_production_mesh,
                     lambda: device_assignment(4)):
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                call()

    def test_runtime_device_must_be_the_meshs(self):
        other = dist.Mesh([dist.LogicalDevice(0, torch.device("meta"))],
                          ("data",))
        with dist.use_mesh(other):
            with pytest.raises(ValueError, match="the mesh on"):
                _rt(executor="sharded").zeros((8, 8), (4, 4))

    def test_profile_apps_mesh_option(self):
        from repro_torch.profile_apps import main, mesh_of
        assert mesh_of(0, "cpu") is None
        assert mesh_of(1, "cpu").devices.flat[0] == \
            dist.default_device("cpu")
        assert [d.id for d in mesh_of(3, "cpu").devices.flat] == [0, 1, 2]
        with pytest.raises(SystemExit):
            main(["--mesh", "2"])             # needs --executor sharded

    def test_use_mesh_nests_and_restores(self):
        assert dist.current() is None
        outer, inner = cpu_mesh(1), cpu_mesh(2)
        with dist.use_mesh(outer) as a:
            with dist.use_mesh(inner, data_axes="data") as b:
                assert dist.current() is b and b.mesh is inner
            assert dist.current() is a
        assert dist.current() is None


# ---------------------------------------------------------------------------
class TestDeviceAssignment:
    def test_no_mesh_every_home_maps_to_default_device(self):
        assert dist.current() is None
        devs = device_assignment(4, device="cpu")
        assert len(devs) == 4
        assert all(d == dist.default_device("cpu") for d in devs)

    def test_block_cyclic_over_mesh_devices(self):
        with dist.use_mesh(cpu_mesh(3)) as ctx:
            devs = device_assignment(4, ctx)
            mesh_devs = list(ctx.mesh.devices.flat)
            assert [d.id for d in devs] == [0, 1, 2, 0]
            for h, d in enumerate(devs):
                assert d is mesh_devs[h % len(mesh_devs)]

    @pytest.mark.parametrize("ndev", [1, 2, 3, 4])
    def test_assignment_matches_reference_ids(self, ndev):
        """Home -> device id equals the reference's over forced host
        devices: ``h % ndev`` (the reference's ids over jax's devices)."""
        with dist.use_mesh(cpu_mesh(ndev)) as ctx:
            got = [d.id for d in device_assignment(6, ctx)]
        assert got == [h % ndev for h in range(6)]

    def test_roundtrip_matches_home_histogram(self):
        ba = BlockArray((32, 32), (4, 4), device="cpu")    # 64 blocks
        assign_homes(ba, "striped", n_homes=4)
        ref = RefBlockArray((32, 32), (4, 4))
        ref_placement.assign_homes(ref, "striped", n_homes=4)
        hist = home_histogram(ba, 4)
        assert hist == ref_placement.home_histogram(ref, 4) == \
            [16, 16, 16, 16]
        with dist.use_mesh(cpu_mesh(2)) as ctx:
            per_dev: dict = {}
            for h, d in enumerate(device_assignment(4, ctx)):
                per_dev[d] = per_dev.get(d, 0) + hist[h]
        assert sum(per_dev.values()) == 64
        assert max(per_dev.values()) == min(per_dev.values())

    @pytest.mark.parametrize("policy", ["single", "striped", "striped_diag",
                                        "striped_rows"])
    def test_homes_and_histograms_match_reference(self, policy):
        ba = BlockArray((24, 24), (4, 4), device="cpu")
        ref = RefBlockArray((24, 24), (4, 4))
        assign_homes(ba, policy, n_homes=4)
        ref_placement.assign_homes(ref, policy, n_homes=4)
        assert ba.home == ref.home
        assert home_histogram(ba, 4) == ref_placement.home_histogram(ref, 4)
        devs = device_assignment(4, device="cpu")
        assert all(devs[h % len(devs)] is not None for h in ba.home.values())

    def test_home_sharding_follows_its_docstring(self):
        """The block axis over every mesh axis when the device count
        divides the block count, else replicated; None with no mesh."""
        ba = BlockArray((32, 32), (4, 4), device="cpu")   # 64 blocks
        odd = BlockArray((12, 4), (4, 4), device="cpu")   # 3 blocks
        assert home_sharding(ba) is None
        with dist.use_mesh(cpu_mesh(1)) as ctx:
            s = home_sharding(ba, ctx)
            assert s.mesh is ctx.mesh
            assert tuple(s.spec) == ("data",)
        with dist.use_mesh(cpu_mesh(shape=(2, 2),
                                    axes=("data", "model"))) as ctx:
            assert tuple(home_sharding(ba, ctx).spec) == \
                (("data", "model"),)
            assert tuple(home_sharding(odd, ctx).spec) == ()
        # the reference gives the same specs on its one-device mesh
        with ref_dist.use_mesh(ref_dist.single_device_mesh()) as ctx:
            for port_ba, shape in ((ba, (32, 32)), (odd, (12, 4))):
                ref_s = ref_placement.home_sharding(
                    RefBlockArray(shape, (4, 4)), ctx)
                with dist.use_mesh(cpu_mesh(1)) as pctx:
                    assert tuple(home_sharding(port_ba, pctx).spec) == \
                        tuple(ref_s.spec)


# ---------------------------------------------------------------------------
class TestOwnerComputes:
    def test_owner_is_home_of_first_output_block(self):
        with _rt(executor="sharded", placement="striped",
                 n_controllers=4) as rt:
            A = rt.zeros((16, 16), (4, 4))
            B = rt.zeros((16, 16), (4, 4))
            f = _gemm(A[1, 2], B[0, 0], B[0, 1])
            assert owner_home(f.descriptor) == A.home[(1, 2)]
            rt.barrier()

    def test_cross_home_bytes_single_placement_is_zero(self):
        a = np.random.default_rng(0).standard_normal((64, 64),
                                                     dtype=np.float32)
        rt = _rt(executor="sharded", placement="single")
        _gemm_program(rt, a, a)
        s = rt.stats()
        assert s.cross_home_bytes == 0
        assert s.local_home_bytes > 0

    def test_cross_home_bytes_striped_gemm_exact(self):
        a = np.random.default_rng(1).standard_normal((128, 128),
                                                     dtype=np.float32)
        rt = _rt(executor="sharded", placement="striped", n_controllers=4)
        _gemm_program(rt, a, a, tile=32)
        s = rt.stats()
        g, block_bytes = 4, 32 * 32 * 4
        assert s.cross_home_bytes == g * g * (g - 1) * block_bytes
        assert s.local_home_bytes == (3 * g ** 3 - g * g * (g - 1)) \
            * block_bytes

    def test_accounting_identical_with_and_without_mesh(self):
        a = np.random.default_rng(2).standard_normal((64, 64),
                                                     dtype=np.float32)
        rt1 = _rt(executor="sharded", placement="striped_diag")
        _gemm_program(rt1, a, a)
        with dist.use_mesh(cpu_mesh(1)):
            rt2 = _rt(executor="sharded", placement="striped_diag")
            _gemm_program(rt2, a, a)
        s1, s2 = rt1.stats(), rt2.stats()
        assert s1.cross_home_bytes == s2.cross_home_bytes
        assert s1.local_home_bytes == s2.local_home_bytes


# ---------------------------------------------------------------------------
class TestShardedExecutor:
    def test_registered_in_config(self):
        cfg = RuntimeConfig(executor="sharded", device="cpu",
                            n_controllers=3).validate()
        with TaskRuntime(cfg) as rt:
            assert isinstance(rt._exec, ShardedExecutor)
            assert rt._exec.n_homes == 3
            ref = repro.TaskRuntime(repro.RuntimeConfig(executor="sharded"))
            assert type(rt._exec).__name__ == type(ref._exec).__name__
            assert rt._exec.kind == ref._exec.kind == "sharded"

    def test_single_device_fallback_no_mesh(self):
        rng = np.random.default_rng(3)
        a = rng.standard_normal((128, 128), dtype=np.float32)
        b = rng.standard_normal((128, 128), dtype=np.float32)
        ref = _gemm_program(_rt(executor="sequential"), a, b)
        rt = _rt(executor="sharded")
        got = _gemm_program(rt, a, b)
        np.testing.assert_array_equal(ref, got)
        s = rt.stats()
        assert s.sharded_dispatches == 0
        assert s.grouped_dispatches and s.grouped_dispatches > 0
        assert s.cross_home_bytes is not None

    def test_per_device_dispatch_under_mesh(self):
        rng = np.random.default_rng(4)
        a = rng.standard_normal((128, 128), dtype=np.float32)
        b = rng.standard_normal((128, 128), dtype=np.float32)
        ref = _gemm_program(_rt(executor="sequential"), a, b)
        with dist.use_mesh(cpu_mesh(1)):
            rt = _rt(executor="sharded")
            got = _gemm_program(rt, a, b)
        np.testing.assert_array_equal(ref, got)
        s = rt.stats()
        assert s.sharded_dispatches == s.grouped_dispatches > 0

    def test_firstprivate_values_ride_the_sharded_dispatch(self):
        @task(in_="x", out="y", firstprivate="k")
        def affine(x, k, y=None):
            return x * k

        def run(executor, mesh):
            ctx = dist.use_mesh(cpu_mesh(4)) if mesh \
                else contextlib.nullcontext()
            with ctx:
                with _rt(executor=executor) as rt:
                    X = rt.full((16, 16), (4, 4), 1.0)
                    Y = rt.zeros((16, 16), (4, 4))
                    for n, (i, j) in enumerate(
                            (i, j) for i in range(4) for j in range(4)):
                        affine(X[i, j], float(n), Y[i, j])
                    rt.barrier()
                    return Y.gather().numpy(), rt.stats()

        ref, _ = run("sequential", mesh=False)
        got, s = run("sharded", mesh=True)
        np.testing.assert_array_equal(ref, got)
        assert s.sharded_dispatches == 1

    def test_wait_on_and_futures_still_region_scoped(self):
        with dist.use_mesh(cpu_mesh(2)):
            with _rt(executor="sharded") as rt:
                A = rt.zeros((4, 4), (4, 4))
                B = rt.zeros((4, 4), (4, 4))
                f = _bump(A[0, 0])
                g = _bump(B[0, 0])
                assert not (f.done() or g.done())
                np.testing.assert_allclose(f.result().numpy(), 1.0)
                assert not g.done(), "unrelated task was forced"

    def test_sharded_under_mesh_names_its_fallback(self):
        """The wave backend under a mesh: every group falls back as
        ``sharded_mesh`` and no wave kernel runs; without a mesh the
        same program takes the staged kernel path."""
        from repro_torch.kernels.matmul import kernel as mm
        from repro_torch.obs import InMemoryTracker
        rng = np.random.default_rng(9)
        a = rng.standard_normal((64, 64), dtype=np.float32)
        b = rng.standard_normal((64, 64), dtype=np.float32)

        @task(inout="c", in_=("x", "y"))
        def gemm(c, x, y):
            return c + x @ y

        from repro_torch import register_wave_kernel
        register_wave_kernel(gemm, lambda c, x, y, out_shapes:
                             mm.matmul_batched(x, y, c))

        def run(backend, mesh, tracker=None):
            cm = dist.use_mesh(cpu_mesh(2)) if mesh \
                else contextlib.nullcontext()
            with cm:
                rt = _rt(executor="sharded", kernel_backend=backend,
                         tracker=tracker)
                with rt.scope():
                    A = rt.from_array(a, (16, 16))
                    B = rt.from_array(b, (16, 16))
                    C = rt.zeros((64, 64), (16, 16))
                    for k in range(4):
                        for i in range(4):
                            for j in range(4):
                                gemm(C[i, j], A[i, k], B[k, j])
                    rt.barrier()
                    out = C.gather().numpy()
                stats = rt.stats()
                rt.shutdown()
                return out, stats

        trk = InMemoryTracker()
        ref, _ = run("xla", mesh=True)
        out, stats = run("pallas", mesh=True, tracker=trk)
        np.testing.assert_array_equal(out, ref)
        assert stats.kernel_dispatches == 0
        assert stats.kernel_fallbacks > 0
        assert {e.data["reason"] for e in trk.events_of("kernel_dispatch")} \
            == {"sharded_mesh"}
        out2, stats2 = run("pallas", mesh=False)
        np.testing.assert_allclose(out2, ref, rtol=1e-5, atol=1e-5)
        assert stats2.kernel_dispatches > 0


# ---------------------------------------------------------------------------
# the same programs on both packages
def _expected_gap(got, want) -> None:
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=RTOL, atol=ATOL)


def _agree(port: dict, ref: dict, mesh: bool = True) -> None:
    """Hold one program's port results to the reference's."""
    assert port.keys() == ref.keys()
    stats = dict(port["stats"])
    ref_stats = dict(ref["stats"])
    if not mesh and "reasons" in ref and "fused" in ref["reasons"]:
        # no mesh, the wave backend: the port launches only registered
        # bodies, every other eligible group falls back as no_kernel
        # (the registry's designed deviation; tests/
        # test_torch_differential_ref.py)
        # and where the reference's fused grid ran, the port's vmap did
        pr, rr = dict(port["reasons"]), dict(ref["reasons"])
        assert pr.pop("fused", 0) + pr.pop("no_kernel", 0) == \
            rr.pop("fused", 0) + rr.pop("lowering_failed", 0)
        assert pr == rr
        assert port["modes"] == ["vmap" if m == "pallas" else m
                                 for m in ref["modes"]]
        port = {k: v for k, v in port.items()
                if k not in ("reasons", "modes")}
        ref = {k: v for k, v in ref.items() if k not in ("reasons", "modes")}
    assert stats == ref_stats
    if "after_gather" in ref:
        assert port["after_gather"] == ref["after_gather"]
    for key in ("modes", "reasons", "tiles"):
        if key in ref:
            assert port[key] == ref[key], key
    for name, want in ref.get("out", {}).items():
        _expected_gap(port["out"][name], want)


@pytest.fixture(scope="module")
def one_device():
    """Both packages' programs on this process's one device, with and
    without a mesh, plus the port's sequential oracle."""
    return {(pkg, mesh): run_programs(pkg, 1, mesh=mesh)
            for pkg in ("repro", "repro_torch") for mesh in (False, True)} | \
        {"oracle": run_programs("repro_torch", 1, mesh=False,
                                executor="sequential")}


PROGRAMS_1 = ["gemm_h4", "uneven", "override", "override_tracked",
              "override_striped", "pallas", "firstprivate", "cholesky",
              *(f"app_{a}" for a in APP_SIZES)]


@pytest.mark.parametrize("mesh", [False, True])
@pytest.mark.parametrize("program", PROGRAMS_1)
def test_one_device_counts_match_reference(one_device, program, mesh):
    port = one_device[("repro_torch", mesh)][program]
    ref = one_device[("repro", mesh)][program]
    _agree(port, ref, mesh=mesh)
    if mesh:
        st = port["stats"]
        assert st["bytes_staged"] == 0
        assert st["tile_moves"] == 0          # one device: nothing moves
    if "out" in port:
        oracle = one_device["oracle"][program]["out"]
        for name, want in oracle.items():
            if program == "pallas" and not mesh:
                _expected_gap(port["out"][name], want)   # matmul_batched
            else:
                np.testing.assert_array_equal(
                    np.asarray(port["out"][name], np.float32),
                    np.asarray(want, np.float32))


def _reference_on(ndev: int) -> dict:
    env = dict(os.environ,
               XLA_FLAGS=f"--xla_force_host_platform_device_count={ndev}",
               JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src"), str(ROOT), env.get("PYTHONPATH", "")])
    out = subprocess.run([sys.executable, __file__, str(ndev)], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def multi_device():
    """The reference on 2 and 4 forced host devices (one subprocess per
    count), the port on as many logical CPU devices, and the port's
    sequential oracle."""
    out = {"oracle": run_programs("repro_torch", 1, mesh=False,
                                  executor="sequential")}
    for ndev in (2, 4):
        out[("repro", ndev)] = _reference_on(ndev)
        out[("repro_torch", ndev)] = run_programs("repro_torch", ndev)
    return out


PROGRAMS_N = {2: ["gemm_h2", "gemm_h4", "uneven", "override",
                  "override_tracked", "override_striped", "pallas",
                  "firstprivate", "cholesky",
                  *(f"app_{a}" for a in APP_SIZES)],
              4: ["gemm_h4", "uneven", "override", "override_tracked",
                  "override_striped", "pallas", "firstprivate", "cholesky",
                  *(f"app_{a}" for a in APP_SIZES)]}


@pytest.mark.parametrize("ndev,program", [(n, p) for n, ps in
                                          PROGRAMS_N.items() for p in ps])
def test_multi_device_counts_match_reference(multi_device, ndev, program):
    port = multi_device[("repro_torch", ndev)][program]
    ref = multi_device[("repro", ndev)][program]
    _agree(port, ref)
    assert port["stats"]["bytes_staged"] == 0
    oracle_key = "gemm_h4" if program == "gemm_h2" else program
    oracle = multi_device["oracle"].get(oracle_key, {}).get("out", {})
    for name, want in oracle.items():
        np.testing.assert_array_equal(
            np.asarray(port["out"][name], np.float32),
            np.asarray(want, np.float32))


def test_multi_device_paths_are_all_taken(multi_device):
    """The 4-device programs reach every dispatch path: the split task
    axis, the uneven-wave per-device batches, single tasks on their
    owner device, and real cross-device copies."""
    runs = multi_device[("repro_torch", 4)]
    modes = {m for r in runs.values() for m in r.get("modes", ())}
    assert {"shard_map", "vmap_device", "jit"} <= modes
    assert "vmap_device" in runs["uneven"]["modes"]
    assert runs["gemm_h4"]["stats"]["tile_moves"] > 0
    assert runs["gemm_h4"]["stats"]["bytes_moved"] == \
        runs["gemm_h4"]["stats"]["cross_home_bytes"]
    assert runs["override"]["stats"]["owner_overrides"] > 0
    tiles = runs["gemm_h4"]["tiles"]
    assert set(tiles.values()) == {0, 1, 2, 3}


# ---------------------------------------------------------------------------
# the sharding rules, leaf for leaf
DENSE = ["command-r-35b", "mistral-nemo-12b", "nemotron-4-15b",
         "qwen1.5-4b"]


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}{k}.")
    else:
        yield prefix[:-1], tree


def _port_params(arch):
    from repro_torch import configs
    from repro_torch.models.transformer import Decoder
    cfg = configs.get_config(arch)
    return cfg, Decoder(cfg, device="meta")


def _ref_params(arch):
    from repro.configs import get_config
    from repro.models import api
    cfg = get_config(arch)
    return cfg, jax.eval_shape(
        lambda: api.init_params(jax.random.PRNGKey(0), cfg))


@pytest.mark.parametrize("policy", ["fsdp", "tp", "replicated"])
@pytest.mark.parametrize("arch", DENSE)
def test_param_shardings_match_reference(arch, policy):
    """The port's rules on a (2, 16) mesh of logical devices give the
    reference's specs on an ``AbstractMesh((2, 16))``, leaf for leaf, and
    never an axis that does not divide its dimension."""
    from repro.dist.context import MeshContext as RefContext
    from repro.dist.sharding import param_shardings as ref_rules
    from repro_torch.dist.context import MeshContext
    from repro_torch.dist.sharding import param_shardings

    mesh = cpu_mesh(shape=(2, 16), axes=("data", "model"))
    ref_mesh = jax.sharding.AbstractMesh(
        (2, 16), ("data", "model"),
        axis_types=(jax.sharding.AxisType.Auto,) * 2)
    cfg, params = _port_params(arch)
    ref_cfg, ref_params = _ref_params(arch)
    got = dict(_leaves(param_shardings(cfg, params, MeshContext(mesh),
                                       policy=policy)))
    want = jax.tree_util.tree_leaves_with_path(ref_rules(
        ref_cfg, ref_params, RefContext(ref_mesh), policy=policy),
        is_leaf=lambda x: hasattr(x, "spec"))
    want = {".".join(p.key for p in path): s for path, s in want}
    assert got.keys() == want.keys()
    shapes = dict(_leaves(_as_tree(params)))
    for name, s in got.items():
        assert tuple(s.spec) == tuple(want[name].spec), name
        assert s.mesh is mesh
        for dim, axis in zip(shapes[name].shape, tuple(s.spec)):
            if axis is not None:
                axes = axis if isinstance(axis, tuple) else (axis,)
                assert dim % int(np.prod([mesh.shape[a] for a in axes])) \
                    == 0


def _as_tree(module):
    from repro_torch.models.transformer import tree
    return tree(module)


@pytest.mark.parametrize("model_in_batch", [False, True])
@pytest.mark.parametrize("mesh_shape", [(1, 1), (2, 4), (4, 2)])
def test_batch_and_cache_shardings_match_reference(mesh_shape,
                                                   model_in_batch):
    from repro.dist.context import MeshContext as RefContext
    from repro.dist.sharding import batch_shardings as ref_batch
    from repro.dist.sharding import cache_shardings as ref_cache
    from repro.models import api as ref_api
    from repro_torch import configs
    from repro_torch.dist.context import MeshContext
    from repro_torch.dist.sharding import batch_shardings, cache_shardings
    from repro_torch.models import api

    cfg = configs.get_config("mistral-nemo-12b").reduced()
    from repro.configs import get_config
    ref_cfg = get_config("mistral-nemo-12b").reduced()
    mesh = cpu_mesh(shape=mesh_shape, axes=("data", "model"))
    ref_mesh = jax.sharding.AbstractMesh(
        mesh_shape, ("data", "model"),
        axis_types=(jax.sharding.AxisType.Auto,) * 2)
    ctx = MeshContext(mesh, model_in_batch=model_in_batch)
    ref_ctx = RefContext(ref_mesh, model_in_batch=model_in_batch)
    batch = {"tokens": torch.zeros((8, 16), dtype=torch.int32),
             "mask": torch.zeros((6,))}
    ref_b = ref_batch(ref_cfg, {"tokens": np.zeros((8, 16), np.int32),
                                "mask": np.zeros((6,))}, ref_ctx)
    got_b = batch_shardings(cfg, batch, ctx)
    assert {k: tuple(v.spec) for k, v in got_b.items()} == \
        {k: tuple(v.spec) for k, v in ref_b.items()}
    caches = api.init_cache(cfg, 8, 16, device="meta")
    ref_caches = jax.eval_shape(lambda: ref_api.init_cache(ref_cfg, 8, 16))
    got_c = dict(_leaves(cache_shardings(cfg, caches, ctx)))
    want = {".".join(str(getattr(p, "key", getattr(p, "idx", "")))
                     for p in path): s
            for path, s in jax.tree_util.tree_leaves_with_path(
                ref_cache(ref_cfg, ref_caches, ref_ctx),
                is_leaf=lambda x: hasattr(x, "spec"))}
    # the reference nests the stacked caches one level deeper
    assert sorted(tuple(s.spec) for s in got_c.values()) == \
        sorted(tuple(s.spec) for s in want.values())
