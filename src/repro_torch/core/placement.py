"""Block placement across memory controllers (§4.1-§4.2).

The SCC's four memory controllers give each core a distance-dependent DRAM
latency, and concurrent access to one controller creates strong contention.
The paper's fix is to distribute application data across all controllers
"as uniformly as possible" using padding and non-unit strides at allocation.

Here placement assigns each block a *home* — on the SCC a memory
controller.  This slice runs on one device, so homes are bookkeeping that
the dependence analysis and later the sharded executor read; the mapping
of homes onto devices comes with the sharded slice.
"""
from __future__ import annotations

from typing import Callable

import numpy as np

from .blocks import BlockArray

__all__ = ["assign_homes", "PLACEMENTS"]


def _single(ba: BlockArray, n_homes: int) -> None:
    """Everything behind controller 0 — the paper's pathological baseline
    ("small, concentrated datasets ... within the shared-memory segment of a
    single memory controller")."""
    for idx in ba.block_indices():
        ba.home[idx] = 0


def _striped(ba: BlockArray, n_homes: int) -> None:
    """Block-cyclic striping across all controllers (the paper's padding +
    non-unit-stride allocation pattern)."""
    for i, idx in enumerate(ba.block_indices()):
        ba.home[idx] = i % n_homes


def _striped_diag(ba: BlockArray, n_homes: int) -> None:
    """Diagonal striping: for 2-D grids, ``home = (i + j) % n`` keeps both
    row-walks and column-walks balanced (useful for Cholesky/MM traversals
    where row-major striping aliases the traversal order)."""
    for idx in ba.block_indices():
        ba.home[idx] = int(np.sum(idx)) % n_homes


def _striped_rows(ba: BlockArray, n_homes: int) -> None:
    """Row-banded striping: ``home = i % n`` keeps each block row behind
    one controller, so row-footprint tasks (stencils, row updates) touch
    one home per region."""
    for idx in ba.block_indices():
        ba.home[idx] = int(idx[0]) % n_homes


PLACEMENTS: dict[str, Callable[[BlockArray, int], None]] = {
    "single": _single,
    "striped": _striped,
    "striped_diag": _striped_diag,
    "striped_rows": _striped_rows,
}

# the canonical choice list lives in api.PlacementKind; this registry
# must implement exactly that list, no more, no less
from .api import PLACEMENTS as _PLACEMENT_NAMES  # noqa: E402

assert set(PLACEMENTS) == set(_PLACEMENT_NAMES), \
    "placement.PLACEMENTS drifted from api.PlacementKind"


def assign_homes(ba: BlockArray, policy: str = "striped",
                 n_homes: int = 4) -> BlockArray:
    try:
        PLACEMENTS[policy](ba, n_homes)
    except KeyError:
        raise ValueError(f"unknown placement {policy!r}; "
                         f"one of {sorted(PLACEMENTS)}") from None
    return ba
