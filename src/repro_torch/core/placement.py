"""Block placement across memory controllers (§4.1-§4.2).

The SCC's four memory controllers give each core a distance-dependent DRAM
latency, and concurrent access to one controller creates strong contention.
The paper's fix is to distribute application data across all controllers
"as uniformly as possible" using padding and non-unit strides at allocation.

Here placement assigns each block a *home* — on the SCC a memory
controller, on a device mesh a device.  The DES charges contention per
home; on a mesh :func:`device_assignment` turns homes into a
block-cyclic layout over the mesh's devices, the generalization of the
paper's striping, which the sharded executor places tiles and tasks by.
"""
from __future__ import annotations

from typing import Callable

import numpy as np

from .blocks import BlockArray

__all__ = ["assign_homes", "PLACEMENTS", "home_histogram",
           "device_assignment", "home_sharding", "rebalance_owners"]


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


def rebalance_owners(owners, n_homes: int, skew_threshold: float,
                     base_load=None) -> tuple[list[int], int]:
    """Contention-aware owner override (§4.1–§4.2, generalized).

    ``owners`` is one wave-group's owner home per task.  When the busiest
    home's load exceeds ``skew_threshold`` times the mean load, tasks
    spill one at a time from the hottest home to the least-loaded one —
    trading an extra output transfer (the spilled task now writes home
    across devices, which the memory layer counts) against serializing the
    whole wave behind one controller, exactly the contention the paper's
    Fig 4 measures.  ``skew_threshold <= 0`` disables the override.

    ``base_load`` (one non-negative number per home) is background work
    already queued behind each home — the tracker's live per-device queue
    depth, fed back by the sharded executor — so the skew decision sees
    what each controller is *actually* serving, not just this group.
    Only this group's tasks can move: a home hot on background load alone
    stops the spill loop.  ``None`` (or all zeros) reproduces the
    wave-local behavior exactly.

    Deterministic: ties break on the lowest home id and the latest task
    spills first.  Returns ``(new_owners, n_spilled)``.
    """
    owners = [h % n_homes for h in owners]
    if skew_threshold <= 0 or not owners:
        return owners, 0
    if base_load is None:
        base = [0.0] * n_homes
    else:
        base = [float(b) for b in base_load]
        if len(base) != n_homes:
            raise ValueError(f"base_load needs one entry per home "
                             f"({n_homes}), got {len(base)}")
        if any(b < 0 for b in base):
            raise ValueError("base_load entries must be >= 0")
    wave = [0] * n_homes
    for h in owners:
        wave[h] += 1
    load = [b + w for b, w in zip(base, wave)]
    mean = sum(load) / n_homes
    spilled = 0
    while True:
        hot = max(range(n_homes), key=lambda h: load[h])
        cold = min(range(n_homes), key=lambda h: load[h])
        if load[hot] <= skew_threshold * mean or load[hot] - load[cold] <= 1:
            break
        for i in range(len(owners) - 1, -1, -1):
            if owners[i] == hot:
                owners[i] = cold
                load[hot] -= 1
                load[cold] += 1
                spilled += 1
                break
        else:
            # the hot home's load is all background — nothing of this
            # group's to move there; stop rather than spin
            break
    return owners, spilled


def home_histogram(ba: BlockArray, n_homes: int = 4) -> list[int]:
    hist = [0] * n_homes
    for h in ba.home.values():
        hist[h] += 1
    return hist


# ---------------------------------------------------------------------------
# homes -> mesh devices (the generalization the ShardedExecutor consumes)
def device_assignment(n_homes: int = 4, ctx=None, device=None) -> list:
    """Home id -> logical device: block-cyclic assignment of homes onto
    the ambient mesh's devices, the mesh generalization of controller
    striping — home ``h`` is served by device ``h % ndev``, so striped
    homes spread blocks over every device the way the paper's allocator
    spreads them over the four memory controllers.

    ``ctx`` is a :class:`repro_torch.dist.MeshContext`; when None the
    ambient context (``repro_torch.dist.current()``) is consulted, and
    with no mesh installed every home maps to the logical device of
    ``device`` (``cuda:0`` by default; raises without CUDA) — the
    single-device fallback that lets the same task program run unchanged.
    """
    from .. import dist

    if ctx is None:
        ctx = dist.current()
    if ctx is None:
        devices = [dist.default_device(device)]
    else:
        devices = list(np.asarray(ctx.mesh.devices).flat)
    return [devices[h % len(devices)] for h in range(max(n_homes, 1))]


def home_sharding(ba: BlockArray, ctx=None):
    """A block-cyclic ``NamedSharding`` for the stacked-blocks view of
    ``ba`` — an array of shape ``(n_blocks, *block_shape)`` whose leading
    axis enumerates tiles in ``block_indices()`` order.

    The leading axis is sharded over every mesh axis when the device
    count divides the block count; an indivisible block count degrades
    to replication rather than failing, the guard of
    :mod:`repro_torch.dist.sharding`.  Returns None when no mesh context
    is active (single-device fallback: there is nothing to shard over).
    """
    from .. import dist

    if ctx is None:
        ctx = dist.current()
    if ctx is None:
        return None
    mesh = ctx.mesh
    ndev = int(np.prod([int(mesh.shape[a]) for a in mesh.axis_names]))
    n_blocks = int(np.prod(ba.grid))
    if ndev > 0 and n_blocks % ndev == 0:
        return dist.NamedSharding(mesh, dist.PartitionSpec(
            tuple(mesh.axis_names)))
    return dist.NamedSharding(mesh, dist.PartitionSpec())
