#!/usr/bin/env python3
"""Smoke test of repro_torch on one NVIDIA GPU.

Run from the repository root, with no arguments::

    python3 chip_smoke.py

Phases, each of which must pass (any failure exits non-zero):

1. Card: print ``nvidia-smi --query-gpu=name,power.limit``.
2. Build: compile every hand-written CUDA kernel from ``src/repro_torch/
   csrc`` (one ``nvcc`` per source, all started together).
3. Kernels: at the shapes the paper's apps give them at the §4.2 sizes,
   hold each kernel against its plain PyTorch version on the card (1e-4
   for the GEMM and the tile update, 1e-6 for the halo stencil at all four
   of the Jacobi app's halo shapes: corner, both edges, interior) and time
   the kernel, the plain version and, where one PyTorch call computes the
   same function, that call (``library_ms``), each with CUDA events,
   L2 flushed before every launch.  ``bound_ms`` is the least time the
   card could take: the bytes the function must move over 3.35 TB/s or
   its FP32 operations over 67 TFLOP/s (H100 SXM data sheet), the larger.
4. Apps (the main path): the five apps at the §4.2 sizes through
   ``TaskRuntime(executor="staged", kernel_backend="pallas",
   device="cuda")``; each verifies its own result against a plain
   reference.  The launch counters are zeroed just before and read just
   after; the GEMM, the tile update and the halo stencil must each have
   launched.
5. Parity: at a small size, ``executor="sequential"`` against staged with
   the wave kernels, all five apps, within each app's tolerance.

Then one JSON line of kernel results, the card line again, and last
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12          # H100 SXM, data sheet
FP32_FLOPS_PER_S = 67e12           # H100 SXM, FP32 outside the tensor cores
L2_FLUSH_BYTES = 256 << 20         # > the 50 MB L2


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, flush, reps: int = 25) -> float:
    """Median device time of one call of ``fn``, L2 flushed before each."""
    import torch
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        times.append((start, end))
    torch.cuda.synchronize()
    ms = sorted(s.elapsed_time(e) for s, e in times)
    return ms[len(ms) // 2]


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {what}")


def kernel_phase(dev) -> list[dict]:
    """Each kernel against its plain version at the §4.2 apps' shapes."""
    import torch
    from repro_torch.kernels.jacobi import kernel as jac
    from repro_torch.kernels.matmul import kernel as mm

    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    flush = torch.empty(L2_FLUSH_BYTES // 4, device=dev)
    rows = []

    # matmul app: 16 waves of 256 tasks, 64^3 tiles (n=1024, tile=64)
    n, m, k, nn = 256, 64, 64, 64
    a, b, c = randn(n, m, k), randn(n, k, nn), randn(n, m, nn)
    nbytes = 4 * (a.numel() + b.numel() + 2 * c.numel())
    flops = 2 * n * m * nn * k + n * m * nn
    rows.append(dict(
        name="matmul_batched", wrapper=lambda: mm.matmul_batched(a, b, c),
        plain=lambda: mm.matmul_batched_plain(a, b, c),
        library=lambda: torch.baddbmm(c, a, b), tol=1e-4,
        source="src/repro_torch/csrc/matmul.cu",
        replaces="src/repro/kernels/matmul/kernel.py:38",
        shape=f"{n}x({m},{k})x({k},{nn})", bound=bound(nbytes, flops)))

    # cholesky app: the largest update wave, 120 tasks of 128^3 (n=2048)
    n, m, k, nn = 120, 128, 128, 128
    cu, au, bu = randn(n, m, nn), randn(n, m, k), randn(n, nn, k)
    nbytes = 4 * (au.numel() + bu.numel() + 2 * cu.numel())
    flops = 2 * n * m * nn * k + n * m * nn
    rows.append(dict(
        name="tile_update_batched",
        wrapper=lambda: mm.tile_update_batched(cu, au, bu),
        plain=lambda: mm.tile_update_batched_plain(cu, au, bu),
        library=lambda: torch.baddbmm(cu, au, bu.transpose(1, 2),
                                      alpha=-1.0), tol=1e-4,
        source="src/repro_torch/csrc/matmul.cu",
        replaces="src/repro/kernels/matmul/kernel.py:83",
        shape=f"{n}x({m},{k})x({nn},{k})^T", bound=bound(nbytes, flops)))

    # jacobi app (n=4096, tile=512): the four halo shapes of one
    # iteration, each a wave group with the app's offsets; the corner and
    # edge groups reach the fixed boundary rows and columns.  All four are
    # checked; the interior group (36 halos of 1536^2) is timed.
    g, tile = 8, 512
    groups: dict[tuple[int, int], list[tuple[int, int]]] = {}
    for i in range(g):
        for j in range(g):
            i0, i1 = max(i - 1, 0), min(i + 2, g)
            j0, j1 = max(j - 1, 0), min(j + 2, g)
            groups.setdefault(((i1 - i0) * tile, (j1 - j0) * tile),
                              []).append(((i - i0) * tile, (j - j0) * tile))
    jac_cases = {}
    for (h, w), offsets in sorted(groups.items()):
        halo = randn(len(offsets), h, w)
        r0 = torch.tensor([o[0] for o in offsets], dtype=torch.int64,
                          device=dev)
        c0 = torch.tensor([o[1] for o in offsets], dtype=torch.int64,
                          device=dev)
        jac_cases[(h, w)] = (
            f"{len(offsets)}x({h},{w})->({tile},{tile})",
            lambda halo=halo, r0=r0, c0=c0: jac.jacobi_halo_batched(
                halo, r0, c0, (tile, tile)),
            lambda halo=halo, r0=r0, c0=c0: jac.jacobi_halo_batched_plain(
                halo, r0, c0, (tile, tile)))
    shape, wrapper, plain = jac_cases[(1536, 1536)]
    n = len(groups[(1536, 1536)])
    # each interior tile reads its (tile+2)^2 window once
    nbytes = 4 * (n * (tile + 2) ** 2 + n * tile * tile) + 8 * 2 * n
    flops = 4 * n * tile * tile
    rows.append(dict(
        name="jacobi_halo_batched", wrapper=wrapper, plain=plain,
        library=None, tol=1e-6, checks=list(jac_cases.values()),
        source="src/repro_torch/csrc/jacobi.cu",
        replaces="src/repro/kernels/jacobi/kernel.py:41",
        shape=shape, bound=bound(nbytes, flops)))

    results = []
    for row in rows:
        checks = row.get("checks") or [(row["shape"], row["wrapper"],
                                         row["plain"])]
        err = 0.0
        for shape, wrapper, plain in checks:
            got = wrapper()
            want = plain()
            torch.cuda.synchronize()
            case_err = (got - want).abs().max().item()
            ok = bool(torch.allclose(got, want, rtol=row["tol"],
                                     atol=row["tol"]))
            ok = ok and bool(torch.isfinite(got).all().item())
            print(f"[kernel] {row['name']} {shape}: max_abs_err={case_err} "
                  f"tol={row['tol']} {'ok' if ok else 'FAIL'}", flush=True)
            check(ok, f"{row['name']} {shape} disagrees with its plain "
                      f"version (max_abs_err {case_err}, tolerance "
                      f"{row['tol']})")
            err = max(err, case_err)
        ms = time_ms(row["wrapper"], flush)
        plain_ms = time_ms(row["plain"], flush)
        library_ms = (time_ms(row["library"], flush)
                      if row["library"] is not None else None)
        bound_ms, bound_by = row["bound"]
        print(f"[kernel] {row['name']}: ms={ms} plain_ms={plain_ms} "
              f"library_ms={library_ms} bound_ms={bound_ms} ({bound_by})",
              flush=True)
        results.append(dict(name=row["name"], route="cuda",
                            source=row["source"], replaces=row["replaces"],
                            launches=0, max_abs_err=err, ms=ms,
                            plain_ms=plain_ms, bound_ms=bound_ms,
                            bound_by=bound_by, library_ms=library_ms))
    del flush
    return results


def app_phase(dev) -> dict[str, int]:
    """The main path: the five apps at §4.2 sizes on the wave kernels."""
    import torch
    from repro_torch import RuntimeConfig, TaskRuntime, apps
    from repro_torch.kernels.jacobi import kernel as jac
    from repro_torch.kernels.matmul import kernel as mm
    from repro_torch.obs import InMemoryTracker

    wrappers = {"matmul_batched": mm.matmul_batched,
                "tile_update_batched": mm.tile_update_batched,
                "jacobi_halo_batched": jac.jacobi_halo_batched}
    must_launch = {"matmul": "matmul_batched",
                   "cholesky": "tile_update_batched",
                   "jacobi": "jacobi_halo_batched"}
    total = dict.fromkeys(wrappers, 0)
    for name in ("black_scholes", "matmul", "fft", "jacobi", "cholesky"):
        trk = InMemoryTracker()
        rt = TaskRuntime(RuntimeConfig(
            executor="staged", kernel_backend="pallas", device=str(dev),
            tracker=trk))
        for w in wrappers.values():
            w.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = apps.APPS[name](rt, **apps.PAPER_SIZES[name])  # self-verifies
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: w.launches for k, w in wrappers.items()}
        rt.shutdown()
        stats = rt.stats()
        for arr in (out if isinstance(out, tuple) else (out,)):
            full = arr.gather()
            check(tuple(full.shape) == arr.shape and
                  bool(torch.isfinite(full).all().item()),
                  f"{name}: output {arr.name} not finite or misshapen")
        fallbacks: dict[str, int] = {}
        for e in trk.events_of("kernel_dispatch"):
            if e.data["backend"] != "pallas":
                key = f"{e.data['fn']}:{e.data['reason']}"
                fallbacks[key] = fallbacks.get(key, 0) + 1
        dispatch_s = sum(e.data["wall_s"] for e in trk.events_of("dispatch"))
        print("[app] " + json.dumps(dict(
            app=name, size=apps.PAPER_SIZES[name], wall_s=wall,
            spawn_s=stats.spawn_time_s, barrier_s=stats.barrier_time_s,
            wait_s=stats.wait_time_s, dispatch_s=dispatch_s,
            tasks=stats.tasks_spawned, waves=stats.waves,
            grouped_dispatches=stats.grouped_dispatches,
            kernel_dispatches=stats.kernel_dispatches,
            kernel_fallbacks=stats.kernel_fallbacks,
            fallbacks_by_reason=fallbacks, launches=launches)), flush=True)
        check(stats.kernel_dispatches == sum(launches.values()),
              f"{name}: {stats.kernel_dispatches} wave-kernel dispatches "
              f"but {sum(launches.values())} launches")
        if name in must_launch:
            check(launches[must_launch[name]] > 0,
                  f"{name}: {must_launch[name]} never launched")
        for k, v in launches.items():
            total[k] += v
    return total


PARITY_SIZES = {
    "black_scholes": dict(n_options=8192, task_options=512),
    "matmul": dict(n=256, tile=64),
    "fft": dict(n=128, row_block=32, tile=32),
    "jacobi": dict(n=512, tile=128, iters=2),
    "cholesky": dict(n=512, tile=128),
}
PARITY_TOL = {"black_scholes": (1e-5, 1e-3), "matmul": (2e-4, 2e-4),
              "fft": (2e-2, 2e-1), "jacobi": (1e-5, 1e-5),
              "cholesky": (2e-2, 2e-2)}


def parity_phase(dev) -> None:
    """Sequential vs staged with the wave kernels, small sizes, on the
    card."""
    import torch
    from repro_torch import RuntimeConfig, TaskRuntime, apps

    for name, size in PARITY_SIZES.items():
        outs = {}
        for executor, backend in (("sequential", "xla"),
                                  ("staged", "pallas")):
            rt = TaskRuntime(RuntimeConfig(
                executor=executor, kernel_backend=backend,
                device=str(dev)))
            out = apps.APPS[name](rt, **size)
            rt.shutdown()
            outs[executor] = [a.gather() for a in
                              (out if isinstance(out, tuple) else (out,))]
        rtol, atol = PARITY_TOL[name]
        worst = 0.0
        for s, g in zip(outs["sequential"], outs["staged"]):
            if name == "cholesky":
                s, g = torch.tril(s), torch.tril(g)
            worst = max(worst, (s - g).abs().max().item())
            check(bool(torch.allclose(g, s, rtol=rtol, atol=atol)),
                  f"parity {name}: staged+kernels differ from sequential")
        print(f"[parity] {name} {size}: max_abs_diff={worst} ok", flush=True)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke test runs only on a "
              "GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    try:
        from repro_torch.kernels import _build
    except ImportError as e:
        print(f"chip_smoke: run from the repository root ({e})",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()
    print(f"[card] {card}", flush=True)
    print(f"[card] torch {torch.__version__} cuda {torch.version.cuda} "
          f"{torch.cuda.get_device_name(0)}", flush=True)

    t0 = time.perf_counter()
    libs = _build.build_all()
    print(f"[build] {sorted(libs)} in {time.perf_counter() - t0:.2f} s",
          flush=True)

    kernels = kernel_phase(dev)
    launches = app_phase(dev)
    for row in kernels:
        row["launches"] = launches[row["name"]]
    parity_phase(dev)

    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
