"""Carry the JAX package's state across to the port.

Both packages hand state over as plain data, so neither imports the
other: tiles as ``{tile index: numpy array}`` (what
``np.asarray(ba.get_tile(idx))`` reads from a ``repro`` ``BlockArray``)
and configuration as a dict of ``RuntimeConfig`` fields
(``dataclasses.asdict`` of a ``repro`` config).  The parity tests build
both runtimes' inputs through these functions.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Mapping, Sequence

import numpy as np
import torch

from .core.api import RuntimeConfig
from .core.blocks import BlockArray

__all__ = ["blockarray_from_numpy", "tiles_to_numpy", "config_from_reference"]


def blockarray_from_numpy(tiles: Mapping[tuple, np.ndarray],
                          shape: Sequence[int], block_shape: Sequence[int],
                          dtype, device: torch.device | str,
                          name: str | None = None) -> BlockArray:
    """A port ``BlockArray`` holding ``tiles`` (one numpy array per tile
    index, every index of the grid present) on ``device``.  The dtype is
    canonicalized as the reference's is; register the array with a
    runtime (``TaskRuntime.register``) to assign its homes."""
    ba = BlockArray(shape, block_shape, dtype, name=name, device=device)
    want = set(ba.block_indices())
    got = {tuple(int(i) for i in idx) for idx in tiles}
    if got != want:
        raise ValueError(f"tiles cover {sorted(got)}, the grid "
                         f"{ba.grid} needs {sorted(want)}")
    for idx, tile in tiles.items():
        ba.set_tile(tuple(int(i) for i in idx), torch.as_tensor(
            np.array(tile), dtype=ba.dtype, device=ba.device))
    return ba


def tiles_to_numpy(ba: BlockArray) -> dict[tuple, np.ndarray]:
    """``{tile index: numpy array}`` of a port ``BlockArray`` — the form
    :func:`blockarray_from_numpy` takes."""
    return {idx: ba.get_tile(idx).cpu().numpy()
            for idx in ba.block_indices()}


# fields whose reference values are objects of the JAX package; only
# their "unset" values carry across
_OBJECT_FIELDS = ("sim_cost_fn", "sim_params")


def config_from_reference(fields: Mapping[str, object]) -> RuntimeConfig:
    """The port ``RuntimeConfig`` equal to a reference configuration given
    as its fields.  Enum members become their strings; a tracker carries
    across as a spec string only (a reference tracker instance writes
    reference events); ``device`` may be among the fields (the port's
    one extra field, ``"cuda"`` when absent).  Raises on a field the port
    does not know or a value it cannot take."""
    known = {f.name for f in dataclasses.fields(RuntimeConfig)}
    unknown = sorted(set(fields) - known)
    if unknown:
        raise ValueError(f"unknown RuntimeConfig fields {unknown}")
    out = {}
    for name, value in fields.items():
        if isinstance(value, enum.Enum):
            value = value.value
        if name in _OBJECT_FIELDS and value is not None:
            raise ValueError(f"{name} holds a reference object; it has no "
                             "counterpart in the port yet")
        if name == "tracker" and not (value is None or
                                      isinstance(value, str)):
            raise ValueError("tracker carries across as a spec string or "
                             "None only")
        out[name] = value
    return RuntimeConfig(**out).validate()
