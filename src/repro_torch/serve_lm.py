"""Streaming LM serving on ``repro_torch.serve``: decode requests against
a shared KV arena (the port of the JAX package's ``examples/serve_lm.py``).

The KV cache lives as long-lived ``BlockArray`` state striped along the
sequence axis (the "memory controllers"), and every arriving query
becomes a *small task graph*: one ``flash_decode`` partial-attention task
per KV tile of the request's context window, plus one log-sum-exp
combine task.  The dependence analyzer isolates requests touching
different windows, the admission controller bounds the in-flight
footprint bytes, and the arena checkpoints per home through
``repro_torch.ckpt`` so a restart resumes bit-identically.

:func:`run` builds, serves, verifies every row against the plain
``decode_mha`` at the reference's rtol/atol 1e-5, checkpoints, and
restores the arena in a fresh session.  Its defaults are the example's
sizes; :data:`CHIP_SIZES` holds the card's.  Per-request latency is
host-side completion, as in the reference: on CUDA a task completes when
its body has queued its kernels.

    PYTHONPATH=src python -m repro_torch.serve_lm --device cpu
    PYTHONPATH=src python -m repro_torch.serve_lm --chip      # on a card
"""
from __future__ import annotations

import argparse
import contextlib
import tempfile
import time

import numpy as np
import torch

from .core import RuntimeConfig, task
from .kernels.flash_decode import ops as fd_ops
from .kernels.flash_decode import ref as fd_ref
from .obs.profiler import trace_span
from .serve import ServeConfig, Session, footprint_nbytes

__all__ = ["CHIP_SIZES", "SERVE_SPAN", "run", "request_bytes"]

#: the ``torch.profiler`` range around the serving window of :func:`run`
#: (first submit to last completion, synchronized)
SERVE_SPAN = "serve_lm/serve"

S_TILE = 64         # KV rows per tile (one sequence shard = one task)
D = 64              # head dimension
N_TILES = 16        # arena length = N_TILES * S_TILE tokens
SHARDS = 4          # context window per request, in tiles
REQUESTS = 24
BUDGET = 3          # admission budget, in concurrent requests
WORKERS = 4

#: the card's sizes.  The head width is Mistral-NeMo-12B's (head_dim
#: 128); a 512-row KV tile is one kernel block; the arena holds 131,072
#: tokens (K + V 128 MiB in f32), one (layer, KV head) slice of that
#: model's 128k-token cache, since each request's graph is single-head;
#: each request reads an 8,192-token window.  4,352 tasks, 4,096 of them
#: flash-decode launches.
CHIP_SIZES = dict(s_tile=512, d=128, n_tiles=256, shards=16, requests=256,
                  budget=8, workers=4)


@task(in_=("k", "v"), out=("o", "lse"), firstprivate=("q",))
def _partial(k, v, q, o=None, lse=None):
    # one KV shard's partial attention for one query token
    out, l = fd_ops.decode_partial(q[None, None, :], k[None, None],
                                   v[None, None])
    return out[0], l[0][:, None]                # (1, D), (1, 1)


@task(in_=("outs", "lses"), out="dest")
def _combine(outs, lses, dest=None):
    # exact LSE merge of the shard partials -> the request's output row
    o = fd_ops.combine_partials(outs[:, None, None, :], lses[:, :, None])
    return o[0].to(torch.float32)               # (1, D)


def request_bytes(s_tile: int, d: int, shards: int) -> int:
    """One request's footprint: ``shards`` K and V tiles, ``shards``
    partial rows and lse rows, one output row (float32)."""
    return (2 * shards * s_tile * d + shards * (d + 1) + d) * 4


def run(rt_config: RuntimeConfig | None = None, *, s_tile: int = S_TILE,
        d: int = D, n_tiles: int = N_TILES, shards: int = SHARDS,
        requests: int = REQUESTS, budget: int = BUDGET,
        workers: int = WORKERS, ckpt_dir: str | None = None,
        seed: int = 0) -> dict:
    """Serve ``requests`` decode requests, verify, checkpoint, restore.

    ``rt_config`` defaults to the host executor on CUDA; its
    ``n_workers`` is set to ``workers``.  Raises if a row disagrees with
    ``decode_mha``, the admission peak exceeds the budget, or the
    restored arena differs from the served one.  Returns the numbers of
    the run: ``wall_s``, ``req_per_s``, ``p50_ms``/``p99_ms`` (host-side
    completion), ``rows_verified``, ``max_abs_err``, ``stats`` (the
    serving session's ``RuntimeStats``), ``epoch``/``restored_epoch``,
    ``restore_identical`` and ``out`` (the served rows, on the CPU)."""
    config = (rt_config or RuntimeConfig(executor="host")).replace(
        n_workers=workers)
    rng = np.random.default_rng(seed)
    k_init = rng.standard_normal((n_tiles * s_tile, d)).astype(np.float32)
    v_init = rng.standard_normal((n_tiles * s_tile, d)).astype(np.float32)
    queries = rng.standard_normal((requests, d)).astype(np.float32)
    windows = rng.integers(0, n_tiles - shards + 1, requests)
    req_bytes = request_bytes(s_tile, d, shards)

    with contextlib.ExitStack() as stack:
        if ckpt_dir is None:
            ckpt_dir = stack.enter_context(
                tempfile.TemporaryDirectory(prefix="serve_lm_ckpt_"))
        serve = ServeConfig(budget_bytes=budget * req_bytes,
                            checkpoint_dir=ckpt_dir)
        with Session(config, serve) as s:
            dev = s.rt.device
            K = s.from_array(k_init, (s_tile, d), name="K")
            V = s.from_array(v_init, (s_tile, d), name="V")
            OP = s.zeros((requests * shards, d), (1, d), name="op",
                         state=False)
            LSE = s.zeros((requests * shards, 1), (1, 1), name="lse",
                          state=False)
            OUT = s.zeros((requests, d), (1, d), name="out", state=False)
            q_dev = torch.as_tensor(queries, device=dev)

            def submit(i):
                t0, q = int(windows[i]), q_dev[i]
                r0 = i * shards

                def graph():
                    futs = [_partial(K[t0 + j, 0], V[t0 + j, 0], q,
                                     OP[r0 + j, 0], LSE[r0 + j, 0])
                            for j in range(shards)]
                    futs.append(_combine(OP[r0:r0 + shards, 0],
                                         LSE[r0:r0 + shards, 0], OUT[i, 0]))
                    return futs

                footprint = [K[t0:t0 + shards, 0], V[t0:t0 + shards, 0],
                             OP[r0:r0 + shards, 0], LSE[r0:r0 + shards, 0],
                             OUT[i, 0]]
                if footprint_nbytes(footprint) != req_bytes:
                    raise RuntimeError("request footprint drifted from "
                                       "request_bytes()")
                return s.submit(graph, *footprint, name=f"decode-{i}")

            _synchronize(dev)
            # the serving window, named for a profiler: SERVE_SPAN
            with trace_span(SERVE_SPAN):
                t_start = time.perf_counter()
                handles = [submit(i) for i in range(requests)]
                if config.executor == "host":
                    # completions surface between arrivals as workers
                    # finish
                    while not all(h.done() for h in handles):
                        s.poll()
                        time.sleep(0.0005)
                else:
                    s.drain()       # lazy executors complete on a wait
                _synchronize(dev)
                wall = time.perf_counter() - t_start

            # verify every served row against the unsharded plain oracle
            k_all = torch.as_tensor(k_init, device=dev)
            v_all = torch.as_tensor(v_init, device=dev)
            want = torch.empty((requests, d), device=dev)
            for i in range(requests):
                rows = slice(int(windows[i]) * s_tile,
                             (int(windows[i]) + shards) * s_tile)
                want[i] = fd_ref.decode_mha(
                    q_dev[i][None, None, :], k_all[rows][None, None],
                    v_all[rows][None, None])[0, 0]
            got = OUT.gather()
            max_err = (got - want).abs().max().item()
            np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                       rtol=1e-5, atol=1e-5)
            lat = np.asarray([h.latency_s for h in handles]) * 1e3
            stats = s.stats()
            if stats.admission_peak_bytes > stats.admission_budget_bytes:
                raise RuntimeError(
                    f"admission peak {stats.admission_peak_bytes} B over the "
                    f"budget {stats.admission_budget_bytes} B")
            epoch = s.checkpoint(sync=True)

        # simulated restart: a fresh runtime restores the arena
        with Session(config, ServeConfig(checkpoint_dir=ckpt_dir)) as s2:
            K2 = s2.zeros((n_tiles * s_tile, d), (s_tile, d), name="K")
            V2 = s2.zeros((n_tiles * s_tile, d), (s_tile, d), name="V")
            restored = s2.restore_latest()
            identical = all(
                torch.equal(A2.get_tile(idx), A.get_tile(idx))
                for A, A2 in ((K, K2), (V, V2)) for idx in K.block_indices())
        if not identical:
            raise RuntimeError("the restored KV arena differs from the "
                               "served one")
    return dict(wall_s=wall, req_per_s=requests / wall,
                p50_ms=float(np.percentile(lat, 50)),
                p99_ms=float(np.percentile(lat, 99)),
                rows_verified=requests, max_abs_err=max_err, stats=stats,
                epoch=epoch, restored_epoch=restored,
                restore_identical=identical, out=got.cpu())


def _synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--requests", type=int, default=REQUESTS)
    ap.add_argument("--budget", type=int, default=BUDGET,
                    help="admission budget, in concurrent requests")
    ap.add_argument("--workers", type=int, default=None,
                    help=f"host worker threads (default {WORKERS}, or "
                         f"CHIP_SIZES' with --chip)")
    ap.add_argument("--executor", default="host")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (default: a temp dir)")
    ap.add_argument("--chip", action="store_true",
                    help="serve at CHIP_SIZES (the card's sizes)")
    args = ap.parse_args(argv)
    sizes = dict(CHIP_SIZES) if args.chip else dict(
        requests=args.requests, budget=args.budget, workers=WORKERS)
    if args.workers is not None:
        sizes["workers"] = args.workers
    r = run(RuntimeConfig(executor=args.executor, device=args.device),
            ckpt_dir=args.ckpt_dir, **sizes)
    st = r["stats"]
    print(f"[serve_lm] {args.executor} executor, {sizes.get('workers')} "
          f"workers, on {args.device}")
    print(f"[serve_lm] {r['rows_verified']} requests in "
          f"{r['wall_s'] * 1e3:.0f}ms ({r['req_per_s']:.0f} req/s): "
          f"p50 {r['p50_ms']:.1f}ms p99 {r['p99_ms']:.1f}ms (host-side "
          f"completion); max_abs_err {r['max_abs_err']:.3g}")
    print(f"[serve_lm] admission: {st.admission_admitted} admitted / "
          f"{st.admission_submitted} submitted, peak "
          f"{st.admission_peak_bytes}B <= budget "
          f"{st.admission_budget_bytes}B")
    print(f"[serve_lm] restart restored epoch {r['restored_epoch']}: KV "
          f"arena bit-identical")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
