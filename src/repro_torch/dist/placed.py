"""Placed leaves: a tensor laid out over a mesh, one tensor per device.

The counterpart of a sharded ``jax.Array``.  A :class:`Placed` holds a
``NamedSharding`` and, for every logical device of its mesh, the chunk of
the full tensor that ``sharding.devices_indices_map(shape)`` gives that
device, on the device's torch device.  Every chunk is its own storage,
replicas included: on one card the logical devices of a mesh hold their
chunks side by side, so the bytes a device holds
(:func:`bytes_by_device`) are the mesh's memory story.

:func:`device_put` places a tree of tensors (or numpy arrays, or placed
leaves on another layout) by a tree of shardings; :func:`gather` puts a
placed leaf back together as one tensor on the torch device of the mesh's
first device.  Both copy, and count the bytes they copy
(``device_put.copied_bytes``, ``gather.copied_bytes``).  Both
differentiate, each as one autograd node: :func:`gather`'s backward
pass hands every device the chunk of the gradient at its index (the
reduce-scatter of an FSDP step), replicas included; a placement's sums
each device's chunk of the gradient into the full tensor (a chunk that
received none counts as zeros).

What the exchange recorder (``dist.record_exchanges``) sees here:
:func:`gather`'s forward pass is an all-gather over the devices that
hold distinct chunks (its result, the full tensor, once; the bytes the
recorder's all-gathers sum to are ``gather.copied_bytes``), its backward
pass a reduce-scatter over them (each device's result, its chunk).  A
placement is not a collective: :func:`device_put` places the inputs
of a step, as the reference's ``in_shardings`` do, and :func:`reshard`
(a leaf placed anew, or a cache grown stripe by stripe by
``api.pad_caches``) is a placement too, counted with them in
``device_put.copied_bytes`` and recorded as no exchange.  Every count
is scaled by ``metatrace.multiplier()``: 1 except in a ``meta`` trace
that runs a loop's body once for several items.
"""
from __future__ import annotations

import contextlib
import math

import numpy as np
import torch

from .. import metatrace

__all__ = ["Placed", "device_put", "gather", "reshard", "bytes_by_device",
           "placed_leaves", "map_placed", "record_exchanges",
           "record_exchange"]


class Placed:
    """A tensor of ``shape`` laid out by ``sharding``: ``shards`` maps each
    :class:`~repro_torch.dist.LogicalDevice` of the mesh, in
    ``mesh.devices.flat`` order, to its chunk."""

    __slots__ = ("sharding", "shape", "shards", "_index")

    def __init__(self, sharding, shape, shards: dict):
        self.sharding = sharding
        self.shape = torch.Size(shape)
        self.shards = shards
        self._index = None

    @property
    def index(self) -> dict:
        """Each device's index into the full tensor (a tuple of slices)."""
        if self._index is None:
            self._index = self.sharding.devices_indices_map(tuple(self.shape))
        return self._index

    @property
    def dtype(self) -> torch.dtype:
        return next(iter(self.shards.values())).dtype

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def numel(self) -> int:
        return math.prod(self.shape)

    def element_size(self) -> int:
        return next(iter(self.shards.values())).element_size()

    def distinct(self) -> list:
        """``(index, device)`` for the first device holding each distinct
        chunk, in ``mesh.devices.flat`` order."""
        seen, out = set(), []
        for dev, idx in self.index.items():
            key = tuple((s.start, s.stop) for s in _norm(idx, self.shape))
            if key not in seen:
                seen.add(key)
                out.append((idx, dev))
        return out

    def laid_out_as(self, sharding) -> bool:
        """Whether ``sharding`` gives every device this leaf's index."""
        want = sharding.devices_indices_map(tuple(self.shape))
        return want.keys() == self.index.keys() and all(
            _norm(want[d], self.shape) == _norm(i, self.shape)
            for d, i in self.index.items())

    def __getitem__(self, i: int) -> "Placed":
        """Entry ``i`` of a leading dimension the sharding leaves whole
        (a stacked layer): each device's chunk is a view of its own."""
        from . import NamedSharding, PartitionSpec
        spec = tuple(self.sharding.spec) + (None,) * (self.ndim - len(
            self.sharding.spec))
        if not isinstance(i, int) or spec[0] is not None:
            raise IndexError(f"a placed leaf indexes by an int along an "
                             f"unsplit leading dimension (spec {spec})")
        return Placed(NamedSharding(self.sharding.mesh,
                                    PartitionSpec(*spec[1:])),
                      self.shape[1:],
                      {d: t[i] for d, t in self.shards.items()})

    def unbind(self, dim: int = 0) -> list:
        if dim != 0:
            raise ValueError("a placed leaf unbinds along dim 0 only")
        return [self[i] for i in range(self.shape[0])]

    def map(self, fn) -> "Placed":
        """``fn`` over every chunk (which must keep the chunk's shape)."""
        return Placed(self.sharding, self.shape,
                      {d: fn(t) for d, t in self.shards.items()})

    def __repr__(self) -> str:
        return (f"Placed({tuple(self.shape)}, {self.dtype}, "
                f"{self.sharding.spec}, {len(self.shards)} devices)")


def _norm(index, shape) -> tuple:
    """``index`` with every slice's start and stop made explicit."""
    return tuple(slice(*s.indices(n)[:2]) for s, n in zip(index, shape))


def _map(fn, tree):
    """``fn(leaf)`` over a tree (``sharding._map_with_path``'s), a module
    read as the nested dicts of its parameters."""
    from .sharding import _as_tree, _map_with_path
    return _map_with_path(lambda _, x: fn(x), _as_tree(tree))


def _at(tree, path):
    """The subtree of ``tree`` at ``path``, or the leaf that stands for
    the whole subtree there."""
    for key in path:
        if not isinstance(tree, (dict, list, tuple)):
            break
        tree = tree[key]
    return tree


def placed_leaves(tree) -> list:
    """The placed leaves of a tree, in walk order."""
    out = []
    _map(lambda x: out.append(x) if isinstance(x, Placed) else None, tree)
    return out


def map_placed(fn, tree):
    """``fn`` over the placed leaves of a tree, the other leaves kept."""
    return _map(lambda x: fn(x) if isinstance(x, Placed) else x, tree)


class _Place(torch.autograd.Function):
    """A tensor's chunk copy per device in ``index`` order; backward: the
    chunks' gradients summed into the full tensor at their indices."""

    @staticmethod
    def forward(ctx, x, index):
        ctx.shape, ctx.index = x.shape, list(index.values())
        times = metatrace.multiplier()
        out = []
        for dev, idx in index.items():
            part = x[idx]
            out.append(torch.empty(part.shape, dtype=x.dtype,
                                   device=dev.torch_device).copy_(part))
            device_put.copied_bytes += \
                part.numel() * part.element_size() * times
        return tuple(out)

    @staticmethod
    def backward(ctx, *grads):
        g = grads[0].new_zeros(ctx.shape)
        for idx, gi in zip(ctx.index, grads):
            g[idx].add_(gi.to(g.device))
        return g, None


def _place_one(x, sharding) -> Placed:
    """One leaf placed: a chunk copy per device (one autograd node)."""
    if isinstance(x, Placed):
        if x.sharding == sharding:
            return x
        return reshard(x, sharding)
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(np.asarray(x))
    index = sharding.devices_indices_map(tuple(x.shape))
    return Placed(sharding, x.shape,
                  dict(zip(index, _Place.apply(x, index))))


def device_put(tree, shardings):
    """``tree`` with every leaf placed by the matching leaf of
    ``shardings`` (or by ``shardings`` itself when it is one
    ``NamedSharding``): a tree of :class:`Placed`.  A leaf already placed
    by that sharding is returned as it is; one placed otherwise is
    resharded (:func:`reshard`).  Differentiable."""
    from .sharding import _as_tree, _map_with_path
    shardings = _as_tree(shardings)
    return _map_with_path(lambda path, x: _place_one(x, _at(shardings, path)),
                          _as_tree(tree))


device_put.copied_bytes = 0


def _overlap(a, b):
    """The intersection of two normalized indices, or None."""
    out = []
    for sa, sb in zip(a, b):
        lo, hi = max(sa.start, sb.start), min(sa.stop, sb.stop)
        if lo >= hi:
            return None
        out.append(slice(lo, hi))
    return tuple(out)


def reshard(x: Placed, sharding, shape=None) -> Placed:
    """``x`` laid out by ``sharding`` over a tensor of ``shape`` (``x``'s
    by default; a larger one is zero past ``x``'s extent, which is how
    ``api.pad_caches`` grows a striped cache): each device's chunk is
    assembled from the overlapping parts of ``x``'s distinct chunks, with
    no full tensor made.  The bytes copied count in
    ``device_put.copied_bytes``."""
    shape = torch.Size(x.shape if shape is None else shape)
    if len(shape) != x.ndim or any(n < m for n, m in zip(shape, x.shape)):
        raise ValueError(f"cannot reshard {tuple(x.shape)} to "
                         f"{tuple(shape)}")
    src = [(_norm(idx, x.shape), x.shards[dev]) for idx, dev in x.distinct()]
    shards = {}
    for dev, idx in sharding.devices_indices_map(tuple(shape)).items():
        idx = _norm(idx, shape)
        chunk = torch.zeros([s.stop - s.start for s in idx], dtype=x.dtype,
                            device=dev.torch_device)
        for sidx, t in src:
            ov = _overlap(idx, sidx)
            if ov is None:
                continue
            dst = tuple(slice(o.start - d.start, o.stop - d.start)
                        for o, d in zip(ov, idx))
            part = t[tuple(slice(o.start - s.start, o.stop - s.start)
                           for o, s in zip(ov, sidx))]
            chunk[dst] = part.to(dev.torch_device)
            device_put.copied_bytes += \
                part.numel() * part.element_size() * metatrace.multiplier()
        shards[dev] = chunk
    return Placed(sharding, shape, shards)


class _Gather(torch.autograd.Function):
    """All-gather forward, and in backward each device's chunk of the
    gradient (replicas each get their own copy)."""

    @staticmethod
    def forward(ctx, placed, *chunks):
        ctx.placed = placed
        first = placed.sharding.mesh.devices.flat[0].torch_device
        out = torch.empty(placed.shape, dtype=placed.dtype, device=first)
        for idx, dev in placed.distinct():
            out[idx] = placed.shards[dev].to(first)
        return out

    @staticmethod
    def backward(ctx, grad):
        placed = ctx.placed
        n = len(placed.distinct())
        record_exchange("reduce-scatter",
                         placed.numel() * grad.element_size() // n, n)
        return (None,) + tuple(
            grad[placed.index[dev]].to(dev.torch_device, copy=True)
            for dev in placed.shards)


def gather(x):
    """A placed leaf as one tensor on the torch device of its mesh's
    first device (each distinct chunk copied once; the bytes of the full
    tensor count in ``gather.copied_bytes``); any other leaf as it is."""
    if not isinstance(x, Placed):
        return x
    nbytes = x.numel() * x.element_size()
    gather.copied_bytes += nbytes * metatrace.multiplier()
    record_exchange("all-gather", nbytes, len(x.distinct()))
    return _Gather.apply(x, *x.shards.values())


gather.copied_bytes = 0


# the open exchange recorders, any thread's: a CUDA backward pass runs
# on the autograd engine's thread
_recorders: list = []


@contextlib.contextmanager
def record_exchanges():
    """Collect ``(kind, result_bytes, group_size, times)`` for every
    exchange between logical devices inside the block (``times`` is
    ``metatrace.multiplier()``, 1 on real tensors), a backward pass's
    included; yields the list."""
    log: list = []
    _recorders.append(log)
    try:
        yield log
    finally:
        _recorders.remove(log)


def record_exchange(kind: str, result_bytes: int, group_size: int) -> None:
    """Record one collective with every open :func:`record_exchanges`: as
    each device of its groups sees it (its result's bytes), standing for
    ``metatrace.multiplier()`` executions."""
    if _recorders:
        rec = (kind, int(result_bytes), int(group_size),
               metatrace.multiplier())
        for log in list(_recorders):
            log.append(rec)


def bytes_by_device(tree) -> dict[int, int]:
    """The bytes each logical device holds in the placed leaves of
    ``tree``, by device id."""
    out: dict[int, int] = {}
    for x in placed_leaves(tree):
        for dev, t in x.shards.items():
            out[dev.id] = out.get(dev.id, 0) + t.numel() * t.element_size()
    return dict(sorted(out.items()))
