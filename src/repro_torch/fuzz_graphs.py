"""Seeded random task graphs for differential executor testing — the
port of the JAX package's ``tests/fuzz_graphs.py``.

One seed -> one deterministic task program: a plain-data step list
(:func:`generate`, the reference's generator verbatim, so a seed names the
same program in both packages) replayed onto a fresh runtime by
:func:`run_case`.  Programs mix everything the dependence analyzer, the
dependence managers and the dispatch layers must agree on:

* ``in``/``out``/``inout`` footprints, single-tile and multi-tile,
* overlapping regions (a window task reads a 2x2 tile neighbourhood that
  other tasks write tile-by-tile),
* firstprivate index parameters (scalar offsets into a halo, scale
  factors) so grouped dispatch carries by-value operands,
* a second dtype (an int32 array) so some waves are mixed-dtype — under
  ``kernel_backend="pallas"`` those take the vmap fallback,
* uneven waves: chains, fan-in and independent tasks of one seed layer
  into wavefronts of varying width with 1-task groups in the mix.

The task bodies are module-level, as in the reference, so every path and
every seed shares one function object per body (one ``vmap`` cache, one
wave-grouping key).  ``_gemm`` is registered with the wave registry: under
``kernel_backend="pallas"`` its eligible groups launch ``matmul_batched``
(8x8x8 tiles), every other eligible body falls back as ``no_kernel``.

The module lives in the package, not under ``tests/``, because the card's
smoke test (``chip_smoke.py``) replays the corpus where no JAX is
installed.  A failing seed replays exactly::

    python -m repro_torch.fuzz_graphs --device cpu 7
"""
from __future__ import annotations

import random

import numpy as np
import torch

from .apps import dynamic_slice2d
from .core import RuntimeConfig, TaskRuntime, register_wave_kernel, task
from .kernels.matmul import kernel as mm_kernel
from .kernels.matmul import ops as mm_ops

TILE = 8
GRID = 3                       # float32 arrays are GRIDxGRID tiles
SEEDS = tuple(range(60))       # pinned: >= 50 seeds, replayed verbatim

__all__ = ["SEEDS", "TILE", "GRID", "PATHS", "generate", "run_case",
           "max_gap", "compare_paths"]


# -- the op vocabulary (module-level: one vmap cache across all runs) -------
@task(inout="c", in_="a", firstprivate="alpha")
def _axpy(c, a, alpha):
    return c + alpha * a


@task(in_="src", out="dst", firstprivate="s")
def _scaled_copy(src, s, dst=None):
    return s * src


@task(inout="c", in_=("x", "y"))
def _gemm(c, x, y):
    return mm_ops.matmul(x, y, c)


def _gemm_wave(c, x, y, out_shapes):
    return mm_kernel.matmul_batched(x, y, c)


register_wave_kernel(_gemm, _gemm_wave)


@task(in_="src", out="dst", firstprivate=("r0", "c0"))
def _window(src, r0, c0, dst=None):
    return dynamic_slice2d(src, r0, c0, TILE, TILE) * 0.5


@task(inout="c", in_=("a", "b"))
def _blend(c, a, b):
    return 0.25 * c + 0.5 * a + 0.25 * b


@task(inout="c", in_="m")
def _accum_int(c, m):
    # mixed-dtype group: float32 tile accumulating an int32 tile — under
    # kernel_backend="pallas" this wave takes the vmap fallback
    return c + 0.125 * m.to(torch.float32)


_OPS = ("axpy", "scaled_copy", "gemm", "window", "blend", "accum_int")
_WEIGHTS = (4, 3, 3, 3, 3, 2)


def generate(seed: int) -> list[tuple]:
    """The seed's program: a list of plain-data steps, each
    ``(op, *tile indices / values)`` — no runtime objects, so a failing
    seed replays exactly from this description alone.  The reference's
    generator, draw for draw."""
    rng = random.Random(seed)
    steps: list[tuple] = []
    for _ in range(rng.randint(8, 18)):
        op = rng.choices(_OPS, weights=_WEIGHTS)[0]
        t = lambda: rng.randrange(GRID)
        if op == "axpy":
            steps.append((op, t(), t(), t(), t(),
                          round(rng.uniform(-2, 2), 3)))
        elif op == "scaled_copy":
            # 1x2 tile source/dest strips: multi-tile footprints that
            # overlap single-tile writers
            j = rng.randrange(GRID - 1)
            steps.append((op, t(), j, t(), rng.randrange(GRID - 1),
                          round(rng.uniform(0.5, 1.5), 3)))
        elif op == "gemm":
            steps.append((op, t(), t(), t(), t(), t(), t()))
        elif op == "window":
            # 2x2 halo read + firstprivate offset into it
            i, j = rng.randrange(GRID - 1), rng.randrange(GRID - 1)
            steps.append((op, i, j, rng.randrange(TILE),
                          rng.randrange(TILE), t(), t()))
        elif op == "blend":
            steps.append((op, t(), t(), t(), t(), t(), t()))
        else:                          # accum_int
            steps.append((op, t(), t(), t(), t()))
    return steps


def _spawn(steps: list[tuple], arrs: dict) -> None:
    A, B, C, M = arrs["A"], arrs["B"], arrs["C"], arrs["M"]
    for step in steps:
        op, rest = step[0], step[1:]
        if op == "axpy":
            ci, cj, ai, aj, alpha = rest
            _axpy(C[ci, cj], A[ai, aj], alpha)
        elif op == "scaled_copy":
            si, sj, di, dj, s = rest
            _scaled_copy(A[si, sj:sj + 2], s, B[di, dj:dj + 2])
        elif op == "gemm":
            ci, cj, xi, xj, yi, yj = rest
            _gemm(C[ci, cj], A[xi, xj], B[yi, yj])
        elif op == "window":
            si, sj, r0, c0, di, dj = rest
            _window(B[si:si + 2, sj:sj + 2], r0, c0, C[di, dj])
        elif op == "blend":
            ci, cj, ai, aj, bi, bj = rest
            _blend(C[ci, cj], A[ai, aj], B[bi, bj])
        else:                          # accum_int
            ci, cj, mi, mj = rest
            _accum_int(C[ci, cj], M[mi, mj])


def run_case(seed: int, device: str = "cuda", **config_overrides):
    """Replay one seed's program on a fresh runtime on ``device``.

    Returns ``(outputs, stats)``: the gathered arrays as numpy and the
    run's ``RuntimeStats``.  ``config_overrides`` go to
    :class:`RuntimeConfig` (staged executor unless overridden)."""
    steps = generate(seed)
    rng = np.random.default_rng(seed)          # the reference's inputs
    n = TILE * GRID
    cfg = RuntimeConfig(**{"executor": "staged", **config_overrides,
                           "device": device})
    rt = TaskRuntime(cfg)
    try:
        with rt.scope():
            arrs = {
                name: rt.from_array(
                    rng.standard_normal((n, n)).astype(np.float32),
                    (TILE, TILE), name=name)
                for name in ("A", "B", "C")
            }
            arrs["M"] = rt.from_array(
                rng.integers(-4, 5, size=(n, n)).astype(np.int32),
                (TILE, TILE), name="M")
            _spawn(steps, arrs)
            rt.barrier()
            outputs = {name: ba.gather().cpu().numpy()
                       for name, ba in arrs.items()}
        return outputs, rt.stats()
    finally:
        rt.shutdown()


#: the paths :func:`compare_paths` replays; the sequential oracle first.
#: ``sharded`` runs with no mesh installed, the reference's fuzz path:
#: the staged dispatch plus the owner-computes accounting
PATHS = {
    "sequential": {"executor": "sequential"},
    "staged": {"executor": "staged"},
    "sharded": {"executor": "sharded"},
    "host": {"executor": "host"},
    "staged+pallas": {"executor": "staged", "kernel_backend": "pallas"},
    "staged+sharded-sync": {"executor": "staged", "dep_manager": "sharded",
                            "dep_pump": "sync"},
    "staged+sharded-threaded": {"executor": "staged",
                                "dep_manager": "sharded",
                                "dep_pump": "threaded"},
}
#: paths whose dependence counts are deterministic: the staged executor
#: defers every task to the barrier, so each analyzes the same pending
#: graph.  The sequential oracle runs each task at spawn and the host
#: executor's workers may finish a task before a later spawn is
#: analyzed, so both see fewer live predecessors (their
#: ``tasks_spawned``/``blocks_walked`` still match).
DEFERRED = ("staged", "sharded", "staged+pallas", "staged+sharded-sync",
            "staged+sharded-threaded")


def max_gap(out: dict, want: dict) -> float:
    """Largest absolute difference between two runs' outputs."""
    return max(float(np.abs(out[k].astype(np.float64) -
                            want[k].astype(np.float64)).max()) for k in want)


#: rtol = atol of a float32 output against the sequential oracle on the
#: card (the GEMM kernel's tolerance); on the CPU every path is bit for bit.
CARD_TOL = 1e-4


def compare_paths(seed: int, device: str = "cuda") -> dict:
    """Run one seed on every path of :data:`PATHS` and assert
    equivalence; returns the per-path ``(outputs, stats)``.

    * Outputs: the sharded managers' bit-identical to the central
      ``staged`` run's; every other path bit-identical to the sequential
      oracle on the CPU (every body runs the same torch ops alone, under
      vmap or batched), else within :data:`CARD_TOL` of it (the card: cuBLAS picks other kernels for a batched product and
      ``matmul_batched`` sums in another order).  The int32 array is
      compared bit for bit everywhere: no task writes it.
    * ``tasks_spawned``/``blocks_walked`` equal on every path,
      ``deps_found`` equal across the :data:`DEFERRED` paths.
    * Wire counts (``dep_messages``/``dep_batches``/``dep_lines``) equal
      between the sync and threaded pumps."""
    exact = torch.device(device).type == "cpu"
    runs = {path: run_case(seed, device, **cfg)
            for path, cfg in PATHS.items()}
    ref_out, ref_stats = runs["sequential"]
    for path, (out, st) in runs.items():
        oracle = "staged" if path.startswith("staged+sharded") \
            else "sequential"
        for name, want in runs[oracle][0].items():
            got = out[name]
            if got.dtype != want.dtype:
                raise AssertionError(f"seed {seed} {path} {name}: dtype "
                                     f"{got.dtype} != {want.dtype}")
            bits = exact or oracle == "staged" or \
                want.dtype != np.float32
            ok = np.array_equal(got, want) if bits else \
                np.allclose(got, want, rtol=CARD_TOL, atol=CARD_TOL)
            if not ok:
                raise AssertionError(
                    f"seed {seed} {path} {name}: outputs differ from the "
                    f"{oracle} run (max |d|="
                    f"{max_gap({name: got}, {name: want})}, "
                    f"{'bit for bit' if bits else f'rtol = atol = {CARD_TOL}'})")
        for fld in ("tasks_spawned", "blocks_walked"):
            if getattr(st, fld) != getattr(ref_stats, fld):
                raise AssertionError(f"seed {seed} {path}: {fld} "
                                     f"{getattr(st, fld)} != "
                                     f"{getattr(ref_stats, fld)}")
    dep_ref = runs["staged"][1].deps_found
    for path in DEFERRED:
        if runs[path][1].deps_found != dep_ref:
            raise AssertionError(
                f"seed {seed} {path}: deps_found {runs[path][1].deps_found}"
                f" != {dep_ref} (staged)")
    sync_st = runs["staged+sharded-sync"][1]
    thr_st = runs["staged+sharded-threaded"][1]
    for fld in ("dep_messages", "dep_batches", "dep_lines"):
        if getattr(thr_st, fld) != getattr(sync_st, fld):
            raise AssertionError(f"seed {seed}: {fld} differs across pumps "
                                 f"({getattr(thr_st, fld)} threaded, "
                                 f"{getattr(sync_st, fld)} sync)")
    return runs


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("seeds", nargs="*", type=int)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    for s in args.seeds or SEEDS:
        for step in generate(s):
            print(s, step)
        compare_paths(s, args.device)
        print(f"seed {s}: all paths agree")
