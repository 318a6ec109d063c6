"""``repro_torch.dist`` — the device mesh, its context and sharding rules.

The port of ``repro.dist``.  As in the reference, one controller (this
process) drives every device of a mesh; nothing here needs a process
group.  The pieces the runtime reads:

* :class:`LogicalDevice` — one device of a mesh: an ``id`` and the
  ``torch_device`` its tensors live on.  On distinct cards a logical
  device and a torch device are the same thing (:func:`local_devices`);
  :func:`logical_devices` puts N of them on one torch device, the
  counterpart of XLA's forced host devices, so every line of the
  multi-device code runs on one card or on the CPU.  A tile's location is
  its logical device, recorded by the store that holds it
  (``core.blocks.DeviceTileStore``), never read off the tensor; a move
  between two logical devices that share a torch device is a real copy.
* :class:`Mesh` — an ``np.ndarray`` of logical devices with
  ``axis_names``, a ``.shape`` mapping and ``.devices``.
* :class:`PartitionSpec` / :class:`NamedSharding` — per-dimension axis
  names, and the split of a dimension into contiguous per-device chunks
  in ``mesh.devices.flat`` order (:meth:`NamedSharding.devices_indices_map`).
* :func:`use_mesh` / :func:`current` — install / read the ambient
  :class:`~repro_torch.dist.context.MeshContext`;
  :func:`single_device_mesh` — the smallest mesh.
* :class:`Placed`, :func:`device_put`, :func:`gather` — a tensor laid out
  over a mesh as one chunk per device (``dist.placed``).
* :func:`record_exchanges` — collect the exchanges between logical
  devices inside a block as ``(kind, result_bytes, group_size, times)``,
  the port's counterpart of the collectives in the reference's HLO
  (``launch.hlo_stats.collective_stats`` reads them).  Each counted hop
  maps to a collective kind: :func:`gather` an all-gather, its backward
  pass a reduce-scatter (``dist.placed``); ``attention.combine_stripes``
  three all-reduces over each ``model`` group (the max, the sum and the
  output: the reference's ``pmax`` and ``psum``); ``moe.moe_ffn_ep``'s
  exchange an all-to-all over each EP group, each way;
  ``pipeline_step``'s hops collective-permutes.  Placements
  (:func:`device_put`, :func:`place`, :func:`reshard`) are no
  collective.  The byte counters keep counting as they did.
* :func:`constrain_seq` / :func:`constrain_heads` — the model's two
  hooks, with the reference's divisibility guards: each returns the spec
  it imposes (None without a mesh or where no axis divides), leaves the
  value as it is, and appends ``(kind, shape, spec)`` to every recorder
  :func:`record_constraints` has open.  The attention runs once per mesh
  position on the chunk ``constrain_heads``' spec gives it
  (``models.attention``); :func:`place` is the pin that lays a value out
  by a spec (the stacked experts, ``models.api.prepare``).
"""
from __future__ import annotations

import contextlib
import math
import threading
from dataclasses import dataclass

import numpy as np
import torch

from .context import MeshContext
from . import sharding  # noqa: F401
from .placed import (Placed, bytes_by_device, device_put, gather,  # noqa
                     map_placed, placed_leaves, record_exchange,
                     record_exchanges, reshard)

__all__ = ["MeshContext", "use_mesh", "current", "sharding",
           "single_device_mesh", "LogicalDevice", "logical_devices",
           "local_devices", "default_device", "Mesh", "PartitionSpec",
           "NamedSharding", "Placed", "device_put", "gather", "reshard",
           "bytes_by_device", "placed_leaves", "map_placed",
           "constrain_seq", "constrain_heads", "place",
           "record_constraints", "record_exchanges", "record_exchange",
           "use_context"]

_state = threading.local()


def _torch_device(device) -> torch.device:
    """``device`` (``"cuda"`` when None) with its index made explicit;
    raises when it names CUDA and CUDA is absent."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device={str(device)!r} but CUDA is not available; pass "
                "device='cpu' to build the mesh on the CPU")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    return device


@dataclass(frozen=True)
class LogicalDevice:
    """One device of a mesh: ``id`` orders and names it, ``torch_device``
    is where its tensors live."""
    id: int
    torch_device: torch.device

    def __repr__(self) -> str:
        return f"LogicalDevice({self.id}, {self.torch_device})"


def default_device(device=None) -> LogicalDevice:
    """The logical device of one torch device (``cuda:0`` by default;
    raises without CUDA): what every home maps to with no mesh."""
    device = _torch_device(device)
    return LogicalDevice(device.index or 0, device)


def logical_devices(n: int, device=None) -> list[LogicalDevice]:
    """``n`` logical devices on one torch device (``cuda:0`` by default;
    raises without CUDA), ids ``0..n-1``."""
    if n < 1:
        raise ValueError(f"need at least one device, got {n}")
    device = _torch_device(device)
    return [LogicalDevice(i, device) for i in range(n)]


def local_devices() -> list[LogicalDevice]:
    """One logical device per local CUDA card, id = its index (raises
    without CUDA)."""
    _torch_device("cuda")
    return [LogicalDevice(i, torch.device("cuda", i))
            for i in range(torch.cuda.device_count())]


class Mesh:
    """A single-controller device mesh: ``devices`` is an ``np.ndarray``
    of :class:`LogicalDevice` with one dimension per name of
    ``axis_names``."""

    def __init__(self, devices, axis_names):
        if isinstance(devices, np.ndarray):
            arr = devices
        else:
            flat = list(devices)
            arr = np.empty(len(flat), dtype=object)
            arr[:] = flat
        axis_names = tuple(axis_names)
        if arr.ndim != len(axis_names):
            raise ValueError(f"devices of shape {arr.shape} need "
                             f"{arr.ndim} axis names, got {axis_names}")
        if len(set(axis_names)) != len(axis_names):
            raise ValueError(f"axis names repeat: {axis_names}")
        flat = list(arr.flat)
        if not all(isinstance(d, LogicalDevice) for d in flat):
            raise TypeError("a mesh holds LogicalDevice objects "
                            "(dist.logical_devices / dist.local_devices)")
        if len(set(flat)) != len(flat):
            raise ValueError("a device appears twice in the mesh")
        self.devices = arr
        self.axis_names = axis_names

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def torch_devices(self) -> tuple[torch.device, ...]:
        """The distinct torch devices under the mesh, in flat order."""
        return tuple(dict.fromkeys(d.torch_device for d in self.devices.flat))

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {list(self.devices.flat)})"


def _spec_entry(part):
    """One dimension of a spec: None, an axis name, or a tuple of two or
    more names (a one-name tuple normalizes to the name, as JAX's
    ``PartitionSpec`` does)."""
    if part is None or isinstance(part, str):
        return part
    part = tuple(part)
    if not part:
        return None
    return part[0] if len(part) == 1 else part


class PartitionSpec(tuple):
    """Per-dimension mesh axes (``None`` = replicated along that dim)."""

    def __new__(cls, *parts):
        return super().__new__(cls, (_spec_entry(p) for p in parts))

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


def _axes(entry) -> tuple[str, ...]:
    return () if entry is None else \
        (entry,) if isinstance(entry, str) else entry


@dataclass(frozen=True)
class NamedSharding:
    """A :class:`PartitionSpec` over a :class:`Mesh`."""
    mesh: Mesh
    spec: PartitionSpec

    def __post_init__(self):
        object.__setattr__(self, "spec", PartitionSpec(*self.spec))
        used = [a for e in self.spec for a in _axes(e)]
        unknown = set(used) - set(self.mesh.axis_names)
        if unknown:
            raise ValueError(f"spec {self.spec} names axes {sorted(unknown)}"
                             f" the mesh lacks ({self.mesh.axis_names})")
        if len(set(used)) != len(used):
            raise ValueError(f"spec {self.spec} uses an axis twice")

    def devices_indices_map(self, shape) -> dict:
        """Each device's index into an array of ``shape``: per dimension a
        slice, the dimension split into contiguous chunks over the spec's
        axes (row-major over them, so over every axis the chunks follow
        ``mesh.devices.flat``), ``slice(None)`` where replicated.  Raises
        when an axis product does not divide its dimension."""
        mesh = self.mesh
        if len(self.spec) > len(shape):
            raise ValueError(f"spec {self.spec} has more dims than {shape}")
        out = {}
        for pos in np.ndindex(*mesh.devices.shape):
            index = []
            for d, size in enumerate(shape):
                axes = _axes(self.spec[d]) if d < len(self.spec) else ()
                if not axes:
                    index.append(slice(None))
                    continue
                n = math.prod(mesh.shape[a] for a in axes)
                if size % n:
                    raise ValueError(f"dim {d} of {tuple(shape)} does not "
                                     f"split over {axes} ({n} devices)")
                k = 0
                for a in axes:
                    k = k * mesh.shape[a] + pos[mesh.axis_names.index(a)]
                chunk = size // n
                index.append(slice(k * chunk, (k + 1) * chunk))
            out[mesh.devices[pos]] = tuple(index)
        return out


def current() -> MeshContext | None:
    """The innermost active mesh context, or None."""
    stack = getattr(_state, "stack", None)
    return stack[-1] if stack else None


def single_device_mesh(axis: str = "data", device=None) -> Mesh:
    """A one-device mesh over ``device`` (``cuda:0`` by default; raises
    without CUDA).

    This is the smallest mesh the mesh-dependent code paths accept — the
    :class:`~repro_torch.core.sharded.ShardedExecutor`'s per-device
    dispatch, the sharding rules, ``placement.device_assignment`` — so
    single-device tests exercise the *same* code the real mesh runs, not
    a separate branch.  Install it with :func:`use_mesh`.
    """
    return Mesh([default_device(device)], (axis,))


def use_mesh(mesh, **ctx_kw):
    """Activate ``mesh`` (with axis roles per ``MeshContext``) for the
    dynamic extent of the block; yields the context."""
    return use_context(MeshContext(mesh, **ctx_kw))


@contextlib.contextmanager
def use_context(ctx: MeshContext | None):
    """Install ``ctx`` (a context :func:`current` returned, None for no
    mesh) on this thread for the block: the context is per thread, and
    the autograd engine runs a CUDA backward pass, a checkpoint's
    recompute included, on a thread of its own."""
    stack = getattr(_state, "stack", None)
    if stack is None:
        stack = _state.stack = []
    stack.append(ctx)
    try:
        yield ctx
    finally:
        stack.pop()


# ---------------------------------------------------------------------------
# the model's sharding hooks
@contextlib.contextmanager
def record_constraints():
    """Collect ``(kind, shape, spec)`` for every constraint the hooks
    impose inside the block (kind ``"seq"``, ``"heads"`` or ``"pin"``);
    yields the list."""
    stack = getattr(_state, "recorders", None)
    if stack is None:
        stack = _state.recorders = []
    log: list = []
    stack.append(log)
    try:
        yield log
    finally:
        stack.remove(log)


def _record(kind: str, shape, spec) -> None:
    for log in getattr(_state, "recorders", ()):
        log.append((kind, tuple(shape), spec))


def _constrain(kind, x, spec_builder):
    ctx = current()
    if ctx is None:
        return None
    spec = spec_builder(ctx, tuple(x.shape))
    if spec is not None:
        _record(kind, x.shape, spec)
    return spec


def constrain_seq(x):
    """(B, S, d) activations: batch over the full batch axes.  Returns the
    spec (or None)."""
    def build(ctx, shape):
        if len(shape) < 2:
            return None
        if shape[0] % ctx.full_batch_size() != 0:
            return None
        return PartitionSpec(ctx.batch_axes_full,
                             *([None] * (len(shape) - 1)))
    return _constrain("seq", x, build)


def constrain_heads(x):
    """(B, H, S, D) attention tensors: heads over the model axis, batch
    over the data axes.  Returns the spec (or None)."""
    def build(ctx, shape):
        if len(shape) != 4 or ctx.model_in_batch:
            return None
        b = ctx.all_data_axes if shape[0] % ctx.dp_size() == 0 else None
        m = ctx.model_axis \
            if shape[1] % ctx.axis_size(ctx.model_axis) == 0 else None
        if b is None and m is None:
            return None
        return PartitionSpec(b, m, None, None)
    return _constrain("heads", x, build)


def place(x, spec):
    """``x`` placed by ``spec`` over the ambient mesh (recorded as a
    ``"pin"``): the counterpart of ``with_sharding_constraint`` where the
    layout is kept, not left to a compiler.  Raises without a mesh."""
    ctx = current()
    if ctx is None:
        raise RuntimeError("dist.place needs an ambient mesh (use_mesh)")
    spec = PartitionSpec(*spec)
    _record("pin", x.shape, spec)
    return device_put(x, NamedSharding(ctx.mesh, spec))
