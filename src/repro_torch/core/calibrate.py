"""Calibration of the SCC cost model against the paper's microbenchmarks
(the JAX package's ``core/calibrate.py``, unchanged: pure Python on the
SCC model, so the port's fit and trend checks equal the reference's).

``costmodel.SCCParams`` ships with plausible SCC magnitudes; this module
*fits* the three constants the paper actually measures to the published
microbenchmark shapes and then checks that the fitted model still
reproduces the paper's two qualitative findings:

* **Fig 3** — DRAM access latency grows linearly with the core's mesh-hop
  distance from the memory controller.  The anchor points below are the
  digitized curve (cycles per cache-line access at each hop count); the
  fit recovers ``dram_base_cycles`` (intercept) and ``dram_hop_cycles``
  (slope) by least squares.
* **Fig 4** — concurrent access through one controller degrades
  near-linearly in the number of accessing cores.  The anchors are
  slowdown factors relative to a single accessor; the fit recovers
  ``contention_alpha`` (slope of ``1 + alpha * (cores - 1)``) by
  through-origin least squares on ``slowdown - 1``.

:func:`calibrate` = fit + trend validation: the calibrated parameters
must still make striped placement beat single-controller placement on a
memory-bound task graph (§4.2) and put the granularity sweep's optimum at
an *interior* tile size (§4.3 — too-fine tasks hit the master bottleneck,
too-coarse tasks starve workers).  Validation runs on self-contained
probe graphs so the fit step has no dependency on a benchmarks package.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np

from .costmodel import SCCParams
from .sim import SimTask, sequential_time, simulate

__all__ = ["CalibrationError", "CalibrationResult", "FIG3_LATENCY_CYCLES",
           "FIG4_SLOWDOWN", "fit_params", "validate_trends", "calibrate"]


# Anchor shapes digitized from the paper's microbenchmark figures.
# Fig 3: cycles per cache-line DRAM access vs mesh-hop distance to the MC.
FIG3_LATENCY_CYCLES: dict[int, float] = {
    0: 255.0, 2: 289.0, 4: 321.0, 6: 352.0, 8: 385.0,
}
# Fig 4: slowdown of one accessor when `cores` cores hammer the same MC
# (reference core fixed at the paper's worst-case 9 hops).
FIG4_SLOWDOWN: dict[int, float] = {
    1: 1.00, 2: 1.56, 4: 2.67, 8: 4.88, 16: 9.22, 24: 13.70, 32: 18.10,
}


class CalibrationError(RuntimeError):
    """The fitted parameters no longer reproduce a paper finding."""


@dataclass(frozen=True)
class CalibrationResult:
    """A fitted :class:`SCCParams` plus fit quality and trend checks."""
    params: SCCParams
    fig3_max_rel_err: float
    fig4_max_rel_err: float
    checks: dict = dataclasses.field(default_factory=dict)

    @property
    def ok(self) -> bool:
        return all(self.checks.values()) if self.checks else True

    def as_dict(self) -> dict:
        """JSON-ready summary (consumed by the BENCH emitter)."""
        return {
            "dram_base_cycles": self.params.dram_base_cycles,
            "dram_hop_cycles": self.params.dram_hop_cycles,
            "contention_alpha": self.params.contention_alpha,
            "fig3_max_rel_err": self.fig3_max_rel_err,
            "fig4_max_rel_err": self.fig4_max_rel_err,
            "checks": {k: bool(v) for k, v in self.checks.items()},
        }


def fit_params(base: SCCParams | None = None,
               fig3: dict[int, float] | None = None,
               fig4: dict[int, float] | None = None) -> CalibrationResult:
    """Least-squares fit of the measured constants; everything else keeps
    ``base``'s values (frozen dataclass -> a new instance is returned)."""
    base = base or SCCParams()
    fig3 = fig3 or FIG3_LATENCY_CYCLES
    fig4 = fig4 or FIG4_SLOWDOWN

    hops = np.array(sorted(fig3), dtype=float)
    lat = np.array([fig3[int(h)] for h in hops])
    slope, intercept = np.polyfit(hops, lat, 1)

    cores = np.array(sorted(fig4), dtype=float)
    slow = np.array([fig4[int(c)] for c in cores])
    x, y = cores - 1.0, slow - 1.0
    alpha = float(x @ y / max(x @ x, 1e-12))

    fitted = dataclasses.replace(base,
                                 dram_base_cycles=float(intercept),
                                 dram_hop_cycles=float(slope),
                                 contention_alpha=alpha)
    lat_hat = intercept + slope * hops
    slow_hat = 1.0 + alpha * x
    return CalibrationResult(
        params=fitted,
        fig3_max_rel_err=float(np.max(np.abs(lat_hat - lat) / lat)),
        fig4_max_rel_err=float(np.max(np.abs(slow_hat - slow) / slow)),
    )


# ---------------------------------------------------------------------------
# probe task graphs — minimal shapes of the paper's two findings
def _probe_stream(placement: str, *, n_tasks: int = 256,
                  tile: int = 256) -> list[SimTask]:
    """Independent memory-bound tasks (a jacobi/fft-shaped stream): with
    ``single`` placement every access funnels through MC0 and contention
    dominates; ``striped`` spreads the load over all four controllers."""
    byts = 2.0 * tile * tile * 4
    return [SimTask(tid=i, flops=4.0 * tile * tile, mem_bytes=byts,
                    homes=(i % 4 if placement == "striped" else 0,),
                    n_blocks=2)
            for i in range(n_tasks)]


def _probe_matmul(*, n: int = 1024, tile: int = 64) -> list[SimTask]:
    """The granularity probe: tiled C += A@B at fixed problem size, tasks
    chained over k (same DAG shape as the JAX package's
    ``benchmarks.workloads.matmul``)."""
    g = n // tile
    flops = 2.0 * tile ** 3
    byts = 3 * tile * tile * 4 * 0.15       # L2 tile reuse, per the paper
    tasks, tid = [], 0
    for i in range(g):
        for j in range(g):
            prev = None
            for k in range(g):
                homes = tuple({(i * g + k) % 4, (k * g + j) % 4,
                               (i * g + j) % 4})
                tasks.append(SimTask(
                    tid=tid, flops=flops, mem_bytes=byts, homes=homes,
                    deps=(prev,) if prev is not None else (), n_blocks=3))
                prev = tid
                tid += 1
    return tasks


def granularity_sweep(p: SCCParams, *, workers: int = 43, n: int = 512,
                      tiles=(128, 64, 32, 16)) -> list[dict]:
    """Speedup vs tile size on the matmul probe (§4.3's sweep shape).
    The default sizes are the smallest instance that keeps the sweep's
    optimum interior (too-coarse starves workers of parallelism, too-fine
    hits the master bottleneck); the JAX package's
    ``benchmarks.granularity`` runs the
    paper-size version."""
    rows = []
    for tile in tiles:
        tasks = _probe_matmul(n=n, tile=tile)
        seq = sequential_time(_probe_matmul(n=n, tile=tile), p)
        r = simulate(tasks, workers, p)
        rows.append({"tile": tile, "tasks": len(tasks),
                     "speedup": seq / r.total_s})
    return rows


def validate_trends(p: SCCParams, *, workers: int = 43) -> dict:
    """The paper's qualitative findings, as booleans on model ``p``."""
    checks: dict[str, bool] = {}
    lat = [p.mem_time_s(2 ** 20, h) for h in range(10)]
    checks["fig3_latency_monotone_in_hops"] = \
        all(b > a for a, b in zip(lat, lat[1:]))
    con = [p.mem_time_s(2 ** 20, 9, concurrent=c) for c in range(1, 33)]
    checks["fig4_time_monotone_in_contention"] = \
        all(b > a for a, b in zip(con, con[1:]))

    striped = simulate(_probe_stream("striped"), workers, p).total_s
    single = simulate(_probe_stream("single"), workers, p).total_s
    checks["striped_beats_single"] = striped < 0.7 * single

    sweep = granularity_sweep(p, workers=workers)
    best = max(range(len(sweep)), key=lambda i: sweep[i]["speedup"])
    checks["granularity_interior_optimum"] = 0 < best < len(sweep) - 1
    return checks


def calibrate(base: SCCParams | None = None, *,
              validate: bool = True) -> CalibrationResult:
    """Fit the measured constants and (by default) assert the calibrated
    model still reproduces the paper's trends; raises
    :class:`CalibrationError` when a finding no longer holds."""
    res = fit_params(base)
    if not validate:
        return res
    checks = validate_trends(res.params)
    res = dataclasses.replace(res, checks=checks)
    bad = [k for k, v in checks.items() if not v]
    if bad:
        raise CalibrationError(
            f"calibrated SCCParams no longer reproduce: {', '.join(bad)} "
            f"(fitted {res.as_dict()})")
    return res
