"""Block-structured arrays: the BDDT custom allocator, in PyTorch.

BDDT-SCC splits all application memory into fixed-size *blocks* via a custom
allocator; blocks are the unit of dependence analysis and of placement across
the SCC's four memory controllers.  Here an array registered with the runtime
becomes a :class:`BlockArray` — a grid of tiles, each tile a contiguous torch
tensor of its own on the runtime's device (never a strided view into the
source array).  Tiles are the dependence unit (``deps.py``), the
scheduling-affinity unit (``scheduler.py``) and the placement unit
(``placement.py``: tile -> "memory controller").

Tiles are never written in place: every task body and every kernel writes
a fresh output, and a store swaps the tile object.  A single-tile
:meth:`Region.materialize` therefore hands out the stored tile itself, as
the JAX package does with its immutable arrays.

Residency (§3.2/§5): tiles are held behind a :class:`TileStore` backend.
The default :class:`HostTileStore` keeps *uncommitted* tensors on the
array's device — the single-device path.  :class:`DeviceTileStore` makes
block *homes* physical: every tile is committed to the mesh device
serving its home (``placement.device_assignment``), writes re-commit to
the home, and reads that cross devices are *actual* copies — counted in
the array's attached :class:`TileTraffic`.  A device here is a
``repro_torch.dist.LogicalDevice``; several may share one torch device,
so a tensor's location is the residency layer's record
(:func:`device_of`), never its torch device, and a move between two
logical devices is a real copy even on one card.  Assembly (``gather`` /
``Region.materialize``) is destination-aware: tiles are pulled directly
onto the device that consumes them, never staged through an intermediate
device.

Dtypes follow the JAX package's canonicalization with 64-bit mode off:
float64 becomes float32, int64 int32, uint64 uint32 and complex128
complex64, so tile dtypes, grouping keys and wave-kernel eligibility agree
with the reference on the same inputs.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Any, Iterator, Sequence

import numpy as np
import torch

__all__ = [
    "BlockArray",
    "FootprintSpec",
    "Region",
    "In",
    "Out",
    "InOut",
    "AccessMode",
    "ACCESS_MODES",
    "MODE_CLASSES",
    "coerce_mode",
    "TileTraffic",
    "TileStore",
    "HostTileStore",
    "DeviceTileStore",
    "device_of",
    "canonical_dtype",
    "resolve_device",
    "dtype_name",
]

# the JAX package's dtype canonicalization with 64-bit mode off
_CANONICAL = {
    torch.float64: torch.float32,
    torch.int64: torch.int32,
    torch.complex128: torch.complex64,
    torch.uint64: torch.uint32,
}


def canonical_dtype(dtype) -> torch.dtype:
    """The torch dtype a tile of ``dtype`` is stored as: any torch or
    numpy dtype spelling, narrowed from 64 to 32 bits like ``jnp.asarray``
    with x64 off."""
    if not isinstance(dtype, torch.dtype):
        dtype = torch.from_numpy(np.zeros(0, np.dtype(dtype))).dtype
    return _CANONICAL.get(dtype, dtype)


def resolve_device(device) -> torch.device:
    """``device`` with its index made explicit (``"cuda"`` -> the current
    CUDA device), so two spellings of one device compare equal."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def dtype_name(dtype: torch.dtype) -> str:
    """The numpy-style name of a torch dtype (``torch.float32`` ->
    ``"float32"``), the spelling the JAX package's keys use."""
    return str(dtype).removeprefix("torch.")


# the attribute that records a committed tensor's logical device
_LOCATION = "_bddt_device"


def device_of(x):
    """The logical device a *committed* tensor lives on, else None.

    A tensor is committed when the residency layer placed it (a
    :class:`DeviceTileStore` tile, a pulled operand) or an executor
    recorded it as produced on a mesh device.  Host-store tiles and
    values a caller hands in are uncommitted: they have no residency
    obligation, so moving them is never charged — the reference's
    committed/uncommitted rule, kept by this record rather than by the
    tensor's torch device (which N logical devices may share)."""
    return getattr(x, _LOCATION, None)


def _locate(x, device):
    """Record tensor ``x`` as living on logical ``device`` (None: leave
    it uncommitted); returns ``x``."""
    if device is not None:
        setattr(x, _LOCATION, device)
    return x


def _place(x, device):
    """``x`` committed to logical ``device``, as a tensor object of its
    own: a copy when ``x`` is on another torch device or committed to
    another logical device (a real move, even on one card), else a view
    of ``x``'s storage (committing an uncommitted tensor in place)."""
    if x.device != device.torch_device:
        out = x.to(device.torch_device)
    elif device_of(x) is not None:
        out = x.clone()
    else:
        out = x.view_as(x)
    return _locate(out, device)


@dataclass
class TileTraffic:
    """Measured tile movement, charged at the memory layer where transfers
    actually happen (executors read these into ``RuntimeStats``).

    * ``tile_moves`` / ``bytes_moved`` — cross-device tile transfers with a
      known destination (a consuming device or the tile's home).
    * ``bytes_staged`` — bytes harmonized onto a device *nobody declared*:
      mixed-device assembly that routes data through an intermediate hop.
      The device-resident executors keep this at zero; a nonzero value
      means some path still stages.
    * ``bytes_local`` — reads served in place on the requesting device.
    """
    tile_moves: int = 0
    bytes_moved: int = 0
    bytes_staged: int = 0
    bytes_local: int = 0

    def reset(self) -> None:
        self.tile_moves = self.bytes_moved = 0
        self.bytes_staged = self.bytes_local = 0


def _majority_device(tiles: list):
    """The committed device holding the most of ``tiles`` (deterministic
    tie-break on device id), or None if nothing is committed."""
    counts: dict = {}
    for t in tiles:
        d = device_of(t)
        if d is not None:
            counts[d] = counts.get(d, 0) + 1
    if not counts:
        return None
    return max(sorted(counts, key=lambda d: d.id),
               key=lambda d: counts[d])


def _pull_tiles(tiles: list, device, traffic: TileTraffic | None,
                tile_nbytes: int, staged: bool = False) -> list:
    """Bring every tile to logical ``device`` (None = the majority device,
    chosen only when tiles are committed to *different* devices),
    charging the attached traffic recorder.  One hop per off-destination
    tile — assembly happens ON the destination, never via an
    intermediate device."""
    if device is None:
        devs = {device_of(t) for t in tiles} - {None}
        if len(devs) <= 1:
            # nothing to harmonize; uncommitted tiles join the one
            # committed device's torch device, free of charge
            for d in devs:
                tiles = [t if t.device == d.torch_device
                         else t.to(d.torch_device) for t in tiles]
            return tiles
        device = _majority_device(tiles)
    else:
        staged = False                    # a declared destination is final
    out = []
    for t in tiles:
        src = device_of(t)
        if src == device:
            if traffic is not None:
                traffic.bytes_local += tile_nbytes
            out.append(t)
            continue
        if src is not None and traffic is not None:
            traffic.tile_moves += 1
            traffic.bytes_moved += tile_nbytes
            if staged:
                traffic.bytes_staged += tile_nbytes
        out.append(_place(t, device))
    return out


# ---------------------------------------------------------------------------
# tile storage backends
class TileStore:
    """Where a :class:`BlockArray`'s tiles physically live.

    The base class is the host backend: a dict of uncommitted tensors on
    the array's device, no residency obligations, no traffic accounting —
    exactly the single-device behavior every non-mesh executor wants.
    """

    traffic: TileTraffic | None = None

    def __init__(self):
        self._tiles: dict[tuple[int, ...], Any] = {}

    def get(self, idx: tuple[int, ...]):
        return self._tiles[idx]

    def set(self, idx: tuple[int, ...], value) -> None:
        self._tiles[idx] = value

    def device_for(self, idx: tuple[int, ...]):
        """The residency target of tile ``idx`` (None = uncommitted)."""
        return None

    def indices(self):
        return self._tiles.keys()


class HostTileStore(TileStore):
    """Alias backend for readability: uncommitted tiles on the array's
    device."""


class DeviceTileStore(TileStore):
    """Device-resident tiles: every tile is committed to the logical
    device serving its home (``devmap[home % ndev]``, from
    ``placement.device_assignment``).

    Writes re-commit to the home device — a value produced elsewhere is
    one direct copy home (counted in ``traffic``); a value produced on
    the home (owner-computes) commits in place.  This is what makes block
    homes *real*: a multi-device wave reads each tile where it lives
    instead of shipping everything through a staging device.
    """

    def __init__(self, array: "BlockArray", devmap: Sequence,
                 traffic: TileTraffic | None = None):
        super().__init__()
        self.array = array
        self.devmap = list(devmap)
        self.traffic = traffic

    def device_for(self, idx: tuple[int, ...]):
        home = self.array.home.get(idx, 0)
        return self.devmap[home % len(self.devmap)]

    def set(self, idx: tuple[int, ...], value) -> None:
        dest = self.device_for(idx)
        src = device_of(value)
        if src == dest:
            self._tiles[idx] = value
            return
        if src is not None and self.traffic is not None:
            self.traffic.tile_moves += 1
            self.traffic.bytes_moved += self.array.tile_nbytes
        self._tiles[idx] = _place(value, dest)


def _assemble(nested: np.ndarray) -> torch.Tensor:
    """``jnp.block`` with ``torch.cat``: assemble an N-D grid of N-D tiles
    into one tensor, grid axis ``d`` concatenating along tile axis ``d``."""
    def rec(sub: np.ndarray, axis: int) -> torch.Tensor:
        if sub.ndim == 1:
            parts = list(sub)
        else:
            parts = [rec(sub[i], axis + 1) for i in range(sub.shape[0])]
        return torch.cat(parts, dim=axis) if len(parts) > 1 else parts[0]

    return rec(nested, 0)


# ---------------------------------------------------------------------------
class BlockArray:
    """An N-D array stored as a grid of tiles (BDDT "blocks").

    Tiles are held behind a :class:`TileStore` so that tasks touch only the
    blocks in their declared footprint — the software analogue of the SCC's
    block allocator, where a task's footprint names exactly the DRAM blocks
    it may access.  Swapping the store (``use_store``) changes *where* the
    tiles live without changing any program; ``device`` is where the
    array is built and where a host store keeps its tiles.
    """

    _next_id = itertools.count()

    def __init__(self, shape: Sequence[int], block_shape: Sequence[int],
                 dtype=torch.float32, name: str | None = None, *,
                 device: torch.device | str):
        if len(shape) != len(block_shape):
            raise ValueError("shape and block_shape rank mismatch")
        for s, b in zip(shape, block_shape):
            if s % b != 0:
                raise ValueError(
                    f"shape {tuple(shape)} not divisible by block_shape "
                    f"{tuple(block_shape)}; pad the array first (the paper's "
                    "allocator likewise pads to block multiples)")
        self.shape = tuple(int(s) for s in shape)
        self.block_shape = tuple(int(b) for b in block_shape)
        self.dtype = canonical_dtype(dtype)
        self.device = resolve_device(device)
        self.grid = tuple(s // b for s, b in zip(self.shape, self.block_shape))
        self.array_id = next(BlockArray._next_id)
        self.name = name or f"arr{self.array_id}"
        self._store: TileStore = HostTileStore()
        # tile index tuple -> home id (memory controller)
        self.home: dict[tuple[int, ...], int] = {}
        # measured tile movement; the owning runtime attaches its recorder
        self.traffic: TileTraffic | None = None

    @property
    def tile_nbytes(self) -> int:
        return int(np.prod(self.block_shape)) * self.dtype.itemsize

    # -- storage backend ---------------------------------------------------
    @property
    def store(self) -> TileStore:
        return self._store

    def use_store(self, store: TileStore) -> None:
        """Swap the storage backend, migrating existing tiles.  Initial
        placement is *not* charged as traffic — tiles are being homed, not
        moved between consumers."""
        old, self._store = self._store, store
        saved, store.traffic = store.traffic, None
        try:
            for idx in list(old.indices()):
                store.set(idx, old.get(idx))
        finally:
            store.traffic = saved

    def tile_device(self, idx: tuple[int, ...]):
        """The logical device the stored tile is committed to (None for
        uncommitted host-store tiles)."""
        return device_of(self._store.get(idx))

    # -- construction -----------------------------------------------------
    @classmethod
    def from_array(cls, arr, block_shape: Sequence[int],
                   name: str | None = None, *,
                   device: torch.device | str) -> "BlockArray":
        """Tile ``arr`` (numpy array or tensor) onto ``device``, each tile
        its own contiguous tensor, with the dtype canonicalized."""
        arr = torch.as_tensor(arr)
        ba = cls(arr.shape, block_shape, arr.dtype, name=name, device=device)
        arr = arr.to(device=ba.device, dtype=ba.dtype)
        for idx in ba.block_indices():
            ba._store.set(idx, arr[ba._tile_slices(idx)].clone(
                memory_format=torch.contiguous_format))
        return ba

    @classmethod
    def full(cls, shape, block_shape, fill, dtype=torch.float32,
             name: str | None = None, *,
             device: torch.device | str) -> "BlockArray":
        """Every tile is the same constant tensor: safe to share because
        nothing writes a tile in place."""
        ba = cls(shape, block_shape, dtype, name=name, device=device)
        tile = torch.full(ba.block_shape, fill, dtype=ba.dtype,
                          device=ba.device)
        for idx in ba.block_indices():
            ba._store.set(idx, tile)
        return ba

    @classmethod
    def zeros(cls, shape, block_shape, dtype=torch.float32,
              name: str | None = None, *,
              device: torch.device | str) -> "BlockArray":
        return cls.full(shape, block_shape, 0, dtype, name=name,
                        device=device)

    # -- indexing ----------------------------------------------------------
    def block_indices(self) -> Iterator[tuple[int, ...]]:
        return itertools.product(*[range(g) for g in self.grid])

    def _tile_slices(self, idx: tuple[int, ...]) -> tuple[slice, ...]:
        return tuple(slice(i * b, (i + 1) * b)
                     for i, b in zip(idx, self.block_shape))

    def __getitem__(self, key) -> "Region":
        """``A[i, j]`` (one tile) or ``A[i0:i1, j]`` (tile range) -> Region.

        Indices are in *block* coordinates, exactly as OmpSs task footprints
        name array tiles.
        """
        if not isinstance(key, tuple):
            key = (key,)
        if len(key) != len(self.grid):
            raise IndexError(f"{self.name}: need {len(self.grid)} block "
                             f"indices, got {len(key)}")
        ranges = []
        for k, g in zip(key, self.grid):
            if isinstance(k, slice):
                start, stop, step = k.indices(g)
                if step != 1:
                    raise IndexError("block slices must be unit-stride")
                ranges.append(range(start, stop))
            else:
                k = int(k)
                if k < 0:
                    k += g
                if not 0 <= k < g:
                    raise IndexError(f"block index {k} out of range {g}")
                ranges.append(range(k, k + 1))
        return Region(self, tuple(ranges))

    @property
    def whole(self) -> "Region":
        return Region(self, tuple(range(g) for g in self.grid))

    # -- tile data access (used by the executors) ---------------------------
    def get_tile(self, idx: tuple[int, ...]):
        return self._store.get(idx)

    def set_tile(self, idx: tuple[int, ...], value) -> None:
        if tuple(value.shape) != self.block_shape:
            raise ValueError(
                f"{self.name}{list(idx)}: tile shape {tuple(value.shape)} != "
                f"block shape {self.block_shape}")
        tile = value.contiguous()
        if tile is not value:
            _locate(tile, device_of(value))
        self._store.set(idx, tile)

    def gather(self, device=None) -> torch.Tensor:
        """Assemble the full array from tiles (the read-back at a barrier)
        with ``torch.cat``; the result is a new tensor.

        Mixed-device tiles are assembled *on the destination* — logical
        ``device`` if given, else the device already holding the most
        tiles — so each off-destination tile moves exactly once (no
        staging hop through an intermediate device)."""
        idxs = list(self.block_indices())
        tiles = _pull_tiles([self._store.get(idx) for idx in idxs], device,
                            self.traffic, self.tile_nbytes)
        nested = np.empty(self.grid, dtype=object)
        for idx, tile in zip(idxs, tiles):
            nested[idx] = tile
        out = _assemble(nested)
        return out.clone() if nested.size == 1 else out

    def scatter(self, arr) -> None:
        """Overwrite all tiles from a full array."""
        arr = torch.as_tensor(arr).to(device=self.device, dtype=self.dtype)
        if tuple(arr.shape) != self.shape:
            raise ValueError("scatter shape mismatch")
        for idx in self.block_indices():
            self._store.set(idx, arr[self._tile_slices(idx)].clone(
                memory_format=torch.contiguous_format))

    def __repr__(self):
        return (f"BlockArray({self.name}, shape={self.shape}, "
                f"blocks={self.grid}x{self.block_shape}, "
                f"dtype={dtype_name(self.dtype)}, device={self.device})")


@dataclass(frozen=True)
class FootprintSpec:
    """The static per-task tile view the wave-kernel layer checks: element
    ``shape`` (the region's assembled extent), canonical ``dtype`` string,
    and the tile grid the region spans.  Produced by
    :meth:`Region.footprint_spec`; consumed by ``core/wavekernel.py`` for
    eligibility (rank/dtype homogeneity)."""
    shape: tuple[int, ...]
    dtype: str
    tile_grid: tuple[int, ...]

    @property
    def rank(self) -> int:
        return len(self.shape)

    @property
    def n_tiles(self) -> int:
        return int(np.prod(self.tile_grid)) if self.tile_grid else 1


@dataclass(frozen=True)
class Region:
    """A rectangular range of tiles of one BlockArray — a task footprint item."""
    array: BlockArray
    ranges: tuple[range, ...]

    @property
    def block_ids(self) -> tuple[tuple[int, tuple[int, ...]], ...]:
        """Globally unique block ids: (array_id, tile index)."""
        return tuple((self.array.array_id, idx)
                     for idx in itertools.product(*self.ranges))

    @property
    def tile_indices(self) -> list[tuple[int, ...]]:
        return list(itertools.product(*self.ranges))

    @property
    def shape(self) -> tuple[int, ...]:
        return tuple(len(r) * b
                     for r, b in zip(self.ranges, self.array.block_shape))

    @property
    def nbytes(self) -> int:
        return int(np.prod(self.shape)) * self.array.dtype.itemsize

    def footprint_spec(self) -> FootprintSpec:
        """The static tile-view description the wave-kernel layer reads
        (regions are rectangular tile ranges by construction, so
        shape/grid are exact, never bounding boxes)."""
        return FootprintSpec(self.shape, dtype_name(self.array.dtype),
                             tuple(len(r) for r in self.ranges))

    def materialize(self, device=None) -> torch.Tensor:
        """Assemble this region's tiles into one tensor (task input value).
        A one-tile region returns the tile itself (the stored one when it
        is already on the destination): callers never write into it.

        ``device`` names the consuming logical device: tiles homed there
        are read in place, every other committed tile is copied directly
        onto it (one hop, counted as a measured transfer).  Without a
        destination, mixed-device tiles harmonize onto the majority
        device and the moved bytes are charged as *staged* — the double
        hop the device-resident executors avoid by always naming the
        consumer."""
        idxs = self.tile_indices
        traffic = self.array.traffic
        nbytes = self.array.tile_nbytes
        tiles = _pull_tiles([self.array.get_tile(i) for i in idxs], device,
                            traffic, nbytes, staged=True)
        if len(idxs) == 1:
            return tiles[0]
        grid = tuple(len(r) for r in self.ranges)
        nested = np.empty(grid, dtype=object)
        # tile_indices and the position product enumerate in the same
        # (row-major) order, so the flat tile list zips positionally
        for pos, tile in zip(itertools.product(*[range(g) for g in grid]),
                             tiles):
            nested[pos] = tile
        return _assemble(nested)

    def store(self, value) -> None:
        """Split a produced value back into this region's tiles (task
        output); each tile becomes a contiguous tensor of its own and
        commits wherever the array's store homes it — for a
        device-resident store, tile-by-tile to the home device."""
        idxs = self.tile_indices
        if len(idxs) == 1:
            self.array.set_tile(idxs[0], value)
            return
        if tuple(value.shape) != self.shape:
            raise ValueError(f"store shape {tuple(value.shape)} != region "
                             f"shape {self.shape}")
        bs = self.array.block_shape
        for pos in itertools.product(*[range(len(r)) for r in self.ranges]):
            src = tuple(r[p] for r, p in zip(self.ranges, pos))
            sl = tuple(slice(p * b, (p + 1) * b) for p, b in zip(pos, bs))
            self.array.set_tile(src, _locate(value[sl], device_of(value)))

    def __repr__(self):
        rs = ",".join(f"{r.start}:{r.stop}" if len(r) > 1 else str(r.start)
                      for r in self.ranges)
        return f"{self.array.name}[{rs}]"


class AccessMode:
    """OmpSs data-access attribute on a task argument (§3.1).

    The three concrete modes are reachable as enum-style members —
    ``AccessMode.IN`` / ``AccessMode.OUT`` / ``AccessMode.INOUT`` — and
    every API that takes a mode (``wait_on``, ``tasks_touching``, the
    ``@task(footprint=...)`` mapping form) accepts either a member or
    its plain-string spelling via :func:`coerce_mode`.
    """
    READS = False
    WRITES = False
    MODE = ""          # canonical string spelling, set on subclasses
    # enum-style member aliases, bound after the subclasses below
    IN: "type[AccessMode]"
    OUT: "type[AccessMode]"
    INOUT: "type[AccessMode]"

    def __init__(self, region: Region):
        if not isinstance(region, Region):
            raise TypeError(f"expected a Region (e.g. A[i, j]), got "
                            f"{type(region).__name__}")
        self.region = region

    def __repr__(self):
        return f"{type(self).__name__}({self.region!r})"


class In(AccessMode):
    READS = True
    MODE = "in"


class Out(AccessMode):
    WRITES = True
    MODE = "out"


class InOut(AccessMode):
    READS = True
    WRITES = True
    MODE = "inout"


AccessMode.IN = In
AccessMode.OUT = Out
AccessMode.INOUT = InOut

#: canonical mode spellings, and the class each one names
ACCESS_MODES = ("in", "out", "inout")
MODE_CLASSES: dict[str, type[AccessMode]] = {
    "in": In, "out": Out, "inout": InOut}


def coerce_mode(mode) -> str:
    """Normalize an access-mode spelling to ``"in"``/``"out"``/``"inout"``.

    Accepts the plain strings, the :class:`AccessMode` members
    (``AccessMode.IN`` — i.e. the ``In``/``Out``/``InOut`` classes), or
    an ``AccessMode`` instance; one helper so every mode-taking API
    raises the same ``ValueError`` listing the valid choices.
    """
    if isinstance(mode, type) and issubclass(mode, AccessMode):
        mode = mode.MODE
    elif isinstance(mode, AccessMode):
        mode = mode.MODE
    if mode not in MODE_CLASSES:
        raise ValueError(
            f"mode must be one of {ACCESS_MODES} (or AccessMode.IN/"
            f"OUT/INOUT), got {mode!r}")
    return mode
