"""The paper's five applications as real task-graph programs on the port's
runtime — the port of the JAX package's ``benchmarks/apps.py``, with the
same apps, parameters, seeds and self-verification tolerances.

Each app's kernels are declared once with ``@task`` footprints and called
inside the runtime scope.  Index-parameterized kernels (fft's tile
transpose, jacobi's halo stencil) take their offsets as ``firstprivate``
values, so one shared function covers every tile and the staged executor
batches a whole wavefront into one dispatch.  Under
``kernel_backend="pallas"`` three bodies launch hand-written wave kernels
(``core/wavekernel.py`` registry): ``_gemm`` the batched GEMM, ``_update``
the batched tile update and ``stencil`` the batched halo stencil.  The
defaults are small; the paper's §4.2 sizes are in :data:`PAPER_SIZES`.
"""
from __future__ import annotations

import numpy as np
import torch

from .core import RuntimeConfig, TaskRuntime, register_wave_kernel, task
from .kernels.black_scholes import ops as bs_ops
from .kernels.black_scholes import ref as bs_ref
from .kernels.cholesky import ops as chol_ops
from .kernels.jacobi import kernel as jac_kernel
from .kernels.jacobi import ref as jac_ref
from .kernels.matmul import kernel as mm_kernel
from .kernels.matmul import ops as mm_ops

__all__ = ["APPS", "PAPER_SIZES", "run_app", "dynamic_slice2d",
           "black_scholes_app", "matmul_app", "fft2d_app", "jacobi_app",
           "cholesky_app"]

#: the paper's §4.2 problem sizes (``benchmarks/workloads.py``).  The
#: paper prices 2,000,000 options; 2,097,152 = 4096 x 512 is the nearest
#: size a BlockArray of 512-option blocks holds.
PAPER_SIZES = {
    "black_scholes": dict(n_options=4096 * 512, task_options=512),
    "matmul": dict(n=1024, tile=64),
    "fft": dict(n=1024, row_block=32, tile=32),
    "jacobi": dict(n=4096, tile=512, iters=16),
    "cholesky": dict(n=2048, tile=128),
}


def dynamic_slice2d(x, r0, c0, h: int, w: int):
    """``jax.lax.dynamic_slice(x, (r0, c0), (h, w))`` for a 2-D ``x``: the
    start is clamped so the window fits.  ``r0``/``c0`` may be ints or
    0-d tensors; built from ``index_select`` because ``Tensor.narrow``
    with a batched start has no vmap batching rule."""
    rows, cols = x.shape[0] - h, x.shape[1] - w
    r0 = r0.clamp(0, rows) if torch.is_tensor(r0) else min(max(r0, 0), rows)
    c0 = c0.clamp(0, cols) if torch.is_tensor(c0) else min(max(c0, 0), cols)
    x = x.index_select(0, r0 + torch.arange(h, device=x.device))
    return x.index_select(1, c0 + torch.arange(w, device=x.device))


def _verify(got: torch.Tensor, want, rtol: float, atol: float) -> None:
    np.testing.assert_allclose(got.cpu().numpy(), np.asarray(
        want.cpu() if torch.is_tensor(want) else want), rtol=rtol, atol=atol)


# ---------------------------------------------------------------------------
@task(in_=("spot", "strike", "t", "rate", "vol"), out=("call", "put"))
def _price(spot, strike, t, rate, vol, call=None, put=None):
    return bs_ops.black_scholes(spot, strike, t, rate, vol)


def black_scholes_app(rt: TaskRuntime, n_options: int = 8192,
                      task_options: int = 512, verify: bool = True):
    """Independent pricing tasks — embarrassingly parallel (§4.2)."""
    rng = np.random.default_rng(0)
    cols = {
        "spot": rng.uniform(10, 200, n_options).astype(np.float32),
        "strike": rng.uniform(10, 200, n_options).astype(np.float32),
        "t": rng.uniform(0.1, 2.0, n_options).astype(np.float32),
        "rate": np.full(n_options, 0.03, np.float32),
        "vol": rng.uniform(0.1, 0.6, n_options).astype(np.float32),
    }
    with rt.scope():
        arrays = {k: rt.from_array(v, (task_options,), name=k)
                  for k, v in cols.items()}
        call = rt.zeros((n_options,), (task_options,), name="call")
        put = rt.zeros((n_options,), (task_options,), name="put")

        futures = [
            _price(arrays["spot"][i], arrays["strike"][i], arrays["t"][i],
                   arrays["rate"][i], arrays["vol"][i], call[i], put[i])
            for i in range(n_options // task_options)]
        if verify:
            # independent tasks: every future resolves without a barrier
            rt.wait_all(futures)
        else:
            rt.wait_on(call, put)
    if not verify:
        return call, put
    want_c, want_p = bs_ref.black_scholes(
        *[torch.as_tensor(cols[k], device=rt.device)
          for k in ("spot", "strike", "t", "rate", "vol")])
    _verify(call.gather(), want_c, rtol=1e-5, atol=1e-3)
    _verify(put.gather(), want_p, rtol=1e-5, atol=1e-3)
    return call, put


# ---------------------------------------------------------------------------
@task(inout="c", in_=("x", "y"))
def _gemm(c, x, y):
    return mm_ops.matmul(x, y, c)


def _gemm_wave(c, x, y, out_shapes):
    return mm_kernel.matmul_batched(x, y, c)


register_wave_kernel(_gemm, _gemm_wave)


def matmul_app(rt: TaskRuntime, n: int = 256, tile: int = 64,
               verify: bool = True):
    g = n // tile
    rng = np.random.default_rng(1)
    a = rng.standard_normal((n, n), dtype=np.float32)
    b = rng.standard_normal((n, n), dtype=np.float32)
    with rt.scope():
        A = rt.from_array(a, (tile, tile), name="A")
        B = rt.from_array(b, (tile, tile), name="B")
        C = rt.zeros((n, n), (tile, tile), name="C")

        for i in range(g):
            for j in range(g):
                for k in range(g):
                    _gemm(C[i, j], A[i, k], B[k, j])
        rt.barrier()
    if verify:
        _verify(C.gather(), a @ b, rtol=2e-4, atol=2e-4)
    return C


# ---------------------------------------------------------------------------
@task(in_=("re", "im"), out=("re_out", "im_out"))
def _row_fft(re, im, re_out=None, im_out=None):
    out = torch.fft.fft(re + 1j * im, dim=1)
    return out.real.to(torch.float32), out.imag.to(torch.float32)


def fft2d_app(rt: TaskRuntime, n: int = 256, row_block: int = 32,
              tile: int = 32, verify: bool = True):
    """2-D FFT exactly as the paper structures it: row-FFT tasks on
    32-row blocks, 32x32 tiled transpose tasks, row-FFT tasks again.
    Complex data as separate re/im planes."""
    rng = np.random.default_rng(2)
    x = (rng.standard_normal((n, n)) +
         1j * rng.standard_normal((n, n))).astype(np.complex64)

    with rt.scope():
        Re = rt.from_array(x.real.astype(np.float32), (row_block, n),
                           name="Re")
        Im = rt.from_array(x.imag.astype(np.float32), (row_block, n),
                           name="Im")
        Re1 = rt.zeros((n, n), (row_block, n), name="Re1")
        Im1 = rt.zeros((n, n), (row_block, n), name="Im1")
        ReT = rt.zeros((n, n), (tile, tile), name="ReT")
        ImT = rt.zeros((n, n), (tile, tile), name="ImT")
        Re2 = rt.zeros((n, n), (row_block, n), name="Re2")
        Im2 = rt.zeros((n, n), (row_block, n), name="Im2")

        g = n // row_block
        for r in range(g):
            _row_fft(Re[r, 0], Im[r, 0], Re1[r, 0], Im1[r, 0])
        assert row_block == tile, \
            "paper's §4.2 uses 32-row blocks + 32x32 tiles"
        gt = n // tile

        # one shared TaskFn for every tile: the (row, col) offsets are
        # firstprivate values carried in the descriptor, so a wavefront
        # of transpose tasks shares one batched dispatch
        @task(in_=("re_block", "im_block"), out=("re_t", "im_t"),
              firstprivate=("r0", "c0"))
        def transpose_tile(re_block, im_block, r0, c0,
                           re_t=None, im_t=None):
            re = dynamic_slice2d(re_block, r0, c0, tile, tile)
            im = dynamic_slice2d(im_block, r0, c0, tile, tile)
            return re.mT, im.mT

        for i in range(gt):
            for j in range(gt):
                # source tile (i, j) lives in row-block i*tile//row_block
                rb = (i * tile) // row_block
                r0 = i * tile - rb * row_block
                transpose_tile(Re1[rb, 0], Im1[rb, 0], r0, j * tile,
                               ReT[j, i], ImT[j, i])
        for r in range(g):
            # row r of the transposed matrix spans tile-rows of ReT
            t0 = (r * row_block) // tile
            t1 = ((r + 1) * row_block - 1) // tile
            _row_fft(ReT[t0:t1 + 1, :], ImT[t0:t1 + 1, :],
                     Re2[r, 0], Im2[r, 0])
        rt.barrier()
    if verify:
        got = Re2.gather().cpu().numpy() + 1j * Im2.gather().cpu().numpy()
        want = np.fft.fft2(x).T   # pipeline output stays transposed
        np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-1)
    return Re2, Im2


# ---------------------------------------------------------------------------
def jacobi_app(rt: TaskRuntime, n: int = 256, tile: int = 64,
               iters: int = 4, verify: bool = True):
    """Tiled 5-point Jacobi: each task reads its tile plus the available
    neighbour tiles (one footprint region) and writes its tile — the halo
    dependencies the paper's stencil workloads exhibit."""
    rng = np.random.default_rng(3)
    x0 = rng.standard_normal((n, n)).astype(np.float32)
    g = n // tile
    with rt.scope():
        bufs = [rt.from_array(x0, (tile, tile), name="J0"),
                rt.zeros((n, n), (tile, tile), name="J1")]

        # one shared TaskFn: the tile's offset inside its halo is a
        # firstprivate value, so tasks group by halo *shape* only
        # (corner/edge/interior) and each group batches into one dispatch
        @task(in_="halo", out="dest", firstprivate=("r0", "c0"))
        def stencil(halo, r0, c0, dest=None):
            full = jac_ref.jacobi_step(halo)
            return dynamic_slice2d(full, r0, c0, tile, tile)

        register_wave_kernel(stencil, _stencil_wave)

        for it in range(iters):
            s, d = bufs[it % 2], bufs[(it + 1) % 2]
            for i in range(g):
                for j in range(g):
                    i0, i1 = max(i - 1, 0), min(i + 2, g)
                    j0, j1 = max(j - 1, 0), min(j + 2, g)
                    stencil(s[i0:i1, j0:j1], (i - i0) * tile,
                            (j - j0) * tile, d[i, j])
        rt.barrier()
    if verify:
        want = jac_ref.jacobi(torch.as_tensor(x0, device=rt.device),
                              iters=iters)
        _verify(bufs[iters % 2].gather(), want, rtol=1e-5, atol=1e-5)
    return bufs[iters % 2]


def _stencil_wave(halo, r0, c0, out_shapes):
    [tile_shape] = out_shapes
    return jac_kernel.jacobi_halo_batched(halo, r0, c0, tile_shape)


# ---------------------------------------------------------------------------
@task(inout="a")
def _potrf(a):
    return chol_ops.potrf(a)


@task(in_="l", inout="a")
def _trsm(l, a):
    return chol_ops.trsm(l, a)


@task(inout="c", in_=("x", "y"))
def _update(c, x, y):
    return chol_ops.update(c, x, y)


def _update_wave(c, x, y, out_shapes):
    return mm_kernel.tile_update_batched(c, x, y)


register_wave_kernel(_update, _update_wave)


def cholesky_app(rt: TaskRuntime, n: int = 256, tile: int = 64,
                 verify: bool = True):
    g = n // tile
    rng = np.random.default_rng(4)
    m = rng.standard_normal((n, n)).astype(np.float32)
    spd = m @ m.T + n * np.eye(n, dtype=np.float32)
    with rt.scope():
        A = rt.from_array(spd, (tile, tile), name="Chol")

        for k in range(g):
            _potrf(A[k, k])
            for i in range(k + 1, g):
                _trsm(A[k, k], A[i, k])
            for i in range(k + 1, g):
                for j in range(k + 1, i + 1):
                    _update(A[i, j], A[i, k], A[j, k])
        rt.barrier()
    if verify:
        got = torch.tril(A.gather())
        want = torch.linalg.cholesky(torch.as_tensor(spd, device=rt.device))
        _verify(got, want, rtol=2e-2, atol=2e-2)
    return A


APPS = {
    "black_scholes": black_scholes_app,
    "matmul": matmul_app,
    "fft": fft2d_app,
    "jacobi": jacobi_app,
    "cholesky": cholesky_app,
}


def run_app(name: str, executor: str = "staged", *,
            verify: bool | None = None, app_kwargs: dict | None = None,
            **config_overrides):
    """Run one paper app on a fresh runtime and return its RuntimeStats.

    Every app self-verifies its numerics against the plain reference, so
    a returned stats object means the run was correct.  ``verify=None``
    means "verify unless the executor cannot": the timing-only ``"sim"``
    executor never computes task values, so its runs skip the check (and
    its stats carry ``predicted_total_s``).  ``app_kwargs`` forwards
    problem sizes to the app; ``config_overrides`` go to
    :class:`RuntimeConfig` (``device="cpu"`` runs on the CPU).
    """
    if verify is None:
        verify = executor != "sim"
    config_overrides.setdefault("n_workers", 4)
    rt = TaskRuntime(RuntimeConfig(executor=executor, **config_overrides))
    try:
        APPS[name](rt, verify=verify, **(app_kwargs or {}))
        return rt.stats()
    finally:
        rt.shutdown()
