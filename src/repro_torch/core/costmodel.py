"""SCC hardware cost model — calibrated to the paper's microbenchmarks
(the JAX package's ``core/costmodel.py``).

Figure 3: DRAM access time grows with the core's mesh-hop distance from
the memory controller.  Figure 4: concurrent access through one controller
degrades sharply (near-linear in the number of accessing cores).  This
module models both, plus MPB descriptor traffic and the P54C's
whole-L2 flush/invalidate penalty, and is consumed by

* the DES (``core/sim.py``) behind ``executor="sim"`` and
* the calibration (``core/calibrate.py``).

The SCC mesh, :class:`SCCParams`, :func:`master_core_choice` and
:func:`worker_order` are the reference's, unchanged: they model the
paper's SCC, not the card the port runs on.  Absolute constants are
plausible SCC magnitudes (533 MHz P54C cores, ~256 cycles base DRAM
latency, 8 KB MPBs, 32 B lines); the *shape* of the curves is what the
reproduction validates against the paper.

:class:`H100Params` holds the port's target card for the roofline (the
reference's ``TPUParams``, with the same fields and terms): one NVIDIA
H100 SXM's data-sheet peaks, which ``chip_smoke.py`` reads its bounds
from.
"""
from __future__ import annotations

from dataclasses import dataclass


# SCC topology: 6x4 tile mesh, 2 cores/tile, 4 MCs on the left/right edges
TILE_COLS, TILE_ROWS = 6, 4
MC_TILES = [(0, 0), (0, 2), (5, 0), (5, 2)]


def tile_of_core(core: int) -> tuple[int, int]:
    tile = core // 2
    return tile % TILE_COLS, tile // TILE_COLS


def hops(a: tuple[int, int], b: tuple[int, int]) -> int:
    return abs(a[0] - b[0]) + abs(a[1] - b[1])


def core_mc_hops(core: int, mc: int) -> int:
    return hops(tile_of_core(core), MC_TILES[mc])


def core_core_hops(a: int, b: int) -> int:
    return hops(tile_of_core(a), tile_of_core(b))


@dataclass(frozen=True)
class SCCParams:
    freq_hz: float = 533e6
    # Fig 3: DRAM latency = base + per-hop cycles (round trip)
    dram_base_cycles: float = 256.0
    dram_hop_cycles: float = 16.0
    cacheline_bytes: int = 32
    # Fig 4: contention slope — effective latency multiplier per extra
    # concurrent accessor on the same controller
    contention_alpha: float = 0.55
    # compute: P54C ~0.5 sustained flops/cycle
    flops_per_cycle: float = 0.5
    # L1 hit ratio proxy: fraction of a task's footprint actually fetched
    # from DRAM (rest is cache-resident across the task)
    dram_fraction: float = 1.0
    # MPB: descriptor = one 32B line; cost = base + per-hop
    mpb_base_cycles: float = 45.0
    mpb_hop_cycles: float = 8.0
    # whole-L2 flush / invalidate: the P54C has no partial flush (§6) —
    # WBINVD walks all 8192 lines with writebacks, O(100k) cycles
    flush_cycles: float = 8192 * 20.0
    invalidate_cycles: float = 8192 * 18.0
    # master-side costs (cycles)
    spawn_base_cycles: float = 1200.0
    dep_block_cycles: float = 90.0      # per footprint block walked
    schedule_cycles: float = 350.0
    poll_cycles: float = 120.0
    release_cycles: float = 400.0

    def seconds(self, cycles: float) -> float:
        return cycles / self.freq_hz

    # -- Fig 3: latency vs hops ------------------------------------------------
    def dram_access_cycles(self, n_hops: int) -> float:
        return self.dram_base_cycles + self.dram_hop_cycles * n_hops

    def mem_time_s(self, nbytes: float, n_hops: int,
                   concurrent: int = 1) -> float:
        """Time for one core to move ``nbytes`` through one MC with
        ``concurrent`` total accessors on that controller (Fig 4)."""
        lines = max(nbytes / self.cacheline_bytes, 1.0)
        per_line = self.dram_access_cycles(n_hops)
        factor = 1.0 + self.contention_alpha * max(concurrent - 1, 0)
        return self.seconds(lines * per_line * factor * self.dram_fraction)

    def compute_time_s(self, flops: float) -> float:
        return self.seconds(flops / self.flops_per_cycle)

    def mpb_write_s(self, n_hops: int) -> float:
        return self.seconds(self.mpb_base_cycles +
                            self.mpb_hop_cycles * n_hops)


@dataclass(frozen=True)
class H100Params:
    """Target-hardware constants for the roofline: one NVIDIA H100 SXM
    (NVIDIA's H100 data sheet, dense rates without sparsity, at the card's
    full 700 W power limit; a card set below it runs slower)."""
    # dense bf16 on the tensor cores (data sheet: 989 TFLOP/s)
    peak_flops_bf16: float = 989e12
    # float32 outside the tensor cores (data sheet: 67 TFLOP/s)
    peak_flops_fp32: float = 67e12
    # HBM3, 80 GB (data sheet: 3.35 TB/s)
    hbm_bw: float = 3.35e12
    # NVLink 4: 900 GB/s to the host's other cards, 450 GB/s each way
    # (data sheet)
    nvlink_bw: float = 450e9

    def roofline_terms(self, flops: float, hbm_bytes: float,
                       link_bytes: float, chips: int = 1) -> dict:
        return {
            "compute_s": flops / (chips * self.peak_flops_bf16),
            "memory_s": hbm_bytes / (chips * self.hbm_bw),
            "collective_s": link_bytes / (chips * self.nvlink_bw),
        }


def master_core_choice() -> int:
    """§4.1: the master sits at a middle core minimizing total hops to all
    MPBs and MCs — the paper picks core 16."""
    best, best_cost = None, None
    for c in range(48):
        t = tile_of_core(c)
        mpb = sum(hops(t, tile_of_core(w)) for w in range(48))
        mc = sum(hops(t, m) for m in MC_TILES)
        worst = max(hops(t, tile_of_core(w)) for w in range(48))
        cost = (worst, mpb + mc)
        if best_cost is None or cost < best_cost:
            best, best_cost = c, cost
    return best


def worker_order(master: int) -> list[int]:
    """Workers sorted by distance from the master (§4.1): every additional
    worker is as close to the master as possible."""
    others = [c for c in range(48) if c != master]
    return sorted(others, key=lambda c: (core_core_hops(master, c), c))
