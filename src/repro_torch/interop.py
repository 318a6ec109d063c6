"""Carry the JAX package's state across to the port.

Both packages hand state over as plain data, so neither imports the
other: tiles as ``{tile index: numpy array}`` (what
``np.asarray(ba.get_tile(idx))`` reads from a ``repro`` ``BlockArray``),
configuration as a dict of ``RuntimeConfig`` fields
(``dataclasses.asdict`` of a ``repro`` config; its ``SCCParams`` as a
dict of fields too), and model weights as the reference's parameter
pytree of numpy arrays
(``jax.tree_util.tree_map(np.asarray, params)``), and an AdamW state as
the reference's ``AdamWState`` mapped the same way (or any object with
``step``, ``mu`` and ``nu``).  The parity tests build both packages'
inputs through these functions.  Onto a mesh, place what they return:
``dist.device_put(params_from_reference(tree, cfg, device),
dist.sharding.param_shardings(cfg, decoder, ctx))`` gives the placed
tree the trainer and the server take.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Mapping, Sequence

import numpy as np
import torch

from .core.api import RuntimeConfig
from .core.blocks import BlockArray
from .core.costmodel import SCCParams
from .models.transformer import Decoder, tree, tree_map
from .optim.adamw import AdamWState

__all__ = ["blockarray_from_numpy", "tiles_to_numpy", "config_from_reference",
           "params_from_reference", "params_to_numpy",
           "opt_state_from_reference", "opt_state_to_numpy"]


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


def _sim_params_from_reference(params) -> SCCParams:
    """The port's ``SCCParams`` equal to a reference ``SCCParams``, given
    as the object or as its fields (``dataclasses.asdict`` turns a
    reference configuration's ``sim_params`` into a dict); field by field,
    raising on a field the port does not know."""
    fields = params if isinstance(params, Mapping) else {
        f.name: getattr(params, f.name)
        for f in dataclasses.fields(params)}
    known = {f.name for f in dataclasses.fields(SCCParams)}
    unknown = sorted(set(fields) - known)
    if unknown:
        raise ValueError(f"unknown SCCParams fields {unknown}")
    return SCCParams(**fields)


def config_from_reference(fields: Mapping[str, object]) -> RuntimeConfig:
    """The port ``RuntimeConfig`` equal to a reference configuration given
    as its fields.  Enum members become their strings; a tracker carries
    across as a spec string only (a reference tracker instance writes
    reference events); ``device`` may be among the fields (the port's
    one extra field, ``"cuda"`` when absent); ``sim_params`` carries
    across field by field.  A ``sim_cost_fn`` callable does not: it is
    called with descriptors of the package it was written for, whose
    regions and bodies are JAX arrays and functions.  Raises on a field
    the port does not know or a value it cannot take."""
    known = {f.name for f in dataclasses.fields(RuntimeConfig)}
    unknown = sorted(set(fields) - known)
    if unknown:
        raise ValueError(f"unknown RuntimeConfig fields {unknown}")
    out = {}
    for name, value in fields.items():
        if isinstance(value, enum.Enum):
            value = value.value
        if name == "sim_cost_fn" and value is not None:
            raise ValueError(
                "sim_cost_fn holds a reference cost function, which reads "
                "the reference's task descriptors (JAX arrays and bodies); "
                "pass a port cost function, or None for FlopcountCost")
        if name == "sim_params" and value is not None:
            value = _sim_params_from_reference(value)
        if name == "tracker" and not (value is None or
                                      isinstance(value, str)):
            raise ValueError("tracker carries across as a spec string or "
                             "None only")
        out[name] = value
    return RuntimeConfig(**out).validate()


# ---------------------------------------------------------------------------
def _flatten(tree: Mapping, prefix: str = "") -> dict[str, object]:
    out = {}
    for key, value in tree.items():
        name = f"{prefix}{key}"
        if isinstance(value, Mapping):
            out.update(_flatten(value, name + "."))
        else:
            out[name] = value
    return out


def params_from_reference(tree: Mapping, cfg,
                          device: torch.device | str = "cuda") -> Decoder:
    """The port's ``Decoder`` for ``cfg`` on ``device`` holding the
    reference's parameters, given as its pytree of nested dicts of numpy
    arrays.  Loads leaf by leaf under the pytree path joined by dots
    (``blocks.attn.wq.w``; ``dense_blocks.ffn.up.w`` or
    ``moe_blocks.moe.gate`` for the MoE family); raises on a missing,
    extra or misshapen leaf."""
    decoder = Decoder(cfg, device=device)
    want = decoder.state_dict()
    got = _flatten(tree)
    missing = sorted(set(want) - set(got))
    extra = sorted(set(got) - set(want))
    if missing or extra:
        raise ValueError(f"parameter tree does not match {cfg.name}: "
                         f"missing {missing}, extra {extra}")
    for name, value in got.items():
        arr = np.asarray(value)
        if tuple(arr.shape) != tuple(want[name].shape):
            raise ValueError(f"{name}: shape {tuple(arr.shape)}, "
                             f"{cfg.name} needs {tuple(want[name].shape)}")
    with torch.no_grad():
        for name, param in decoder.named_parameters():
            param.copy_(torch.from_numpy(np.array(got[name],
                                                  dtype=np.float32)))
    return decoder


def params_to_numpy(decoder: Decoder) -> dict:
    """The reference's parameter pytree (nested dicts of numpy arrays) of
    a port ``Decoder`` — the form :func:`params_from_reference` takes."""
    return tree_map(lambda t: t.detach().cpu().numpy(), tree(decoder))


def opt_state_from_reference(state, device: torch.device | str = "cuda"
                             ) -> AdamWState:
    """The port's ``AdamWState`` on ``device`` holding a reference AdamW
    state given with numpy leaves: step as a 0-dim int32 tensor, mu and
    nu as f32 trees with the reference's keys (those of the parameter
    tree, ``params_from_reference``)."""
    def leaf(x):
        return torch.from_numpy(np.array(x, dtype=np.float32)).to(device)

    return AdamWState(
        step=torch.tensor(int(np.asarray(state.step)), dtype=torch.int32,
                          device=device),
        mu=tree_map(leaf, state.mu), nu=tree_map(leaf, state.nu))


def opt_state_to_numpy(state: AdamWState) -> AdamWState:
    """A port AdamW state with numpy leaves (step an int32 0-dim array),
    field for field what :func:`opt_state_from_reference` takes."""
    def leaf(t):
        return t.detach().cpu().numpy()

    return AdamWState(step=leaf(state.step), mu=tree_map(leaf, state.mu),
                      nu=tree_map(leaf, state.nu))
