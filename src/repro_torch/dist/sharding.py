"""Sharding rules: parameter, batch and KV-cache trees -> ``NamedSharding``
trees.

The port of ``repro.dist.sharding``, as pure spec rules over the port's
trees (nested dicts, lists and tuples of tensors, or a module, read as
the nested dicts of its parameters under the reference's pytree paths).
The rules are *divisibility-guarded*: a dimension is only assigned to a
mesh axis when the axis size divides it, so any config can be laid out
on any mesh shape without per-architecture special cases (the qwen
20-head configs are the canonical awkward divisor).  Policies:

* ``fsdp`` — 2-D sharding: one dim tensor-parallel over the model axis,
  one dim fully-sharded over the data axes (params + optimizer state).
* ``tp``   — model-axis tensor parallelism only; serving loads (no
  optimizer state to shard) use this so FSDP doesn't all-gather weights
  every layer for nothing.
* ``replicated`` — everything everywhere (tiny configs, tests).

``dist.device_put`` places a tree by them: the trainer's parameters and
AdamW state (:func:`opt_state_shardings`, the layout the reference's
``dryrun.lower_cell`` builds), the serving caches (``models.api``), a
restored checkpoint (``ckpt.restore_checkpoint(shardings=)``).
"""
from __future__ import annotations

import numpy as np
import torch

from .context import MeshContext

__all__ = ["default_policy", "param_shardings", "batch_shardings",
           "cache_shardings", "opt_state_shardings"]

POLICIES = ("fsdp", "tp", "replicated")


def default_policy(cfg) -> str:
    """FSDP everywhere by default; tiny/test configs stay replicated."""
    if getattr(cfg, "d_model", 0) and cfg.d_model < 128:
        return "replicated"
    return "fsdp"


def _axes_size(mesh, axes) -> int:
    n = 1
    for a in axes:
        n *= int(mesh.shape[a])
    return n


def _assign(shape, dims, axis_or_axes, size, spec, *, skip=()):
    """Put ``axis_or_axes`` on the largest still-free dim it divides."""
    if size <= 1:
        return None
    for d in sorted(dims, key=lambda d: -shape[d]):
        if d in skip or spec[d] is not None:
            continue
        if shape[d] % size == 0:
            spec[d] = axis_or_axes
            return d
    return None


def _as_tree(tree):
    """A module's parameters as nested dicts under their dotted names;
    any other tree as it is."""
    if not hasattr(tree, "named_parameters"):
        return tree
    out: dict = {}
    for name, t in tree.named_parameters():
        *path, leaf = name.split(".")
        node = out
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = t
    return out


def _map_with_path(fn, tree, path=()):
    """``fn(path, leaf)`` over nested dicts, lists, tuples and named
    tuples; the path holds dict keys and sequence indices."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map_with_path(fn, v, path + (i,))
                            for i, v in enumerate(tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def _is_float(leaf) -> bool:
    dt = leaf.dtype
    if isinstance(dt, torch.dtype):
        return dt.is_floating_point
    return bool(np.issubdtype(dt, np.floating))


def param_shardings(cfg, params, ctx: MeshContext, *,
                    policy: str | None = None):
    """``NamedSharding`` tree matching ``params`` leaf-for-leaf."""
    from . import NamedSharding, PartitionSpec as P

    policy = policy or default_policy(cfg)
    if policy not in POLICIES:
        raise ValueError(f"policy must be one of {POLICIES}, got {policy!r}")
    mesh = ctx.mesh
    data = ctx.all_data_axes
    d_size = _axes_size(mesh, data)
    m_axis = ctx.model_axis
    m_size = int(mesh.shape[m_axis])
    # under model_in_batch the model axis carries batch, not TP: fold it
    # into the FSDP group instead so the weights still spread
    if ctx.model_in_batch:
        data = data + (m_axis,)
        d_size *= m_size
        m_size = 1

    def one(_, leaf):
        shape = tuple(getattr(leaf, "shape", ()))
        spec = [None] * len(shape)
        if policy != "replicated" and len(shape) >= 2 and _is_float(leaf):
            # dim 0 of a >=3-D leaf is the stacked-layer axis: never shard
            # it, the layer loop slices it per step
            skip = {0} if len(shape) >= 3 else set()
            dims = range(len(shape))
            _assign(shape, dims, m_axis, m_size, spec, skip=skip)
            if policy == "fsdp":
                _assign(shape, dims, data, d_size, spec, skip=skip)
        return NamedSharding(mesh, P(*spec))

    return _map_with_path(one, _as_tree(params))


def opt_state_shardings(param_sh, ctx: MeshContext):
    """The ``AdamWState`` layout of the reference's ``dryrun.lower_cell``:
    the step replicated, mu and nu laid out like the parameters."""
    from ..optim.adamw import AdamWState
    from . import NamedSharding, PartitionSpec as P
    return AdamWState(step=NamedSharding(ctx.mesh, P()), mu=param_sh,
                      nu=param_sh)


def batch_shardings(cfg, batch, ctx: MeshContext):
    """Shard every batch leaf's leading dim over the full batch axes."""
    from . import NamedSharding, PartitionSpec as P

    mesh = ctx.mesh
    axes = ctx.batch_axes_full
    size = _axes_size(mesh, axes)

    def one(_, leaf):
        shape = tuple(getattr(leaf, "shape", ()))
        spec = [None] * len(shape)
        if shape and shape[0] % size == 0 and size > 1:
            spec[0] = axes
        return NamedSharding(mesh, P(*spec))

    return _map_with_path(one, batch)


# cache leaves that carry a sequence axis at position -2, by dict key
_SEQ_CACHE_KEYS = ("k", "v", "c_kv", "k_rope")


def _cache_key(path) -> str:
    """A cache leaf's name: the nearest dict key on its path (a list of
    per-call-site caches is walked through)."""
    return next((p for p in reversed(path) if isinstance(p, str)), "")


def cache_shardings(cfg, caches, ctx: MeshContext):
    """KV caches: batch over the data axes, sequence striped over the
    model axis (the runtime's memory-controller striping applied to the
    KV data plane).  Recurrent states and anything unrecognized stay
    replicated."""
    from . import NamedSharding, PartitionSpec as P

    mesh = ctx.mesh
    data = ctx.all_data_axes
    d_size = _axes_size(mesh, data)
    m_axis = ctx.model_axis
    m_size = int(mesh.shape[m_axis])
    seq_on_model = m_size > 1 and not ctx.model_in_batch

    def one(path, leaf):
        shape = tuple(getattr(leaf, "shape", ()))
        spec = [None] * len(shape)
        key = _cache_key(path)
        if key in _SEQ_CACHE_KEYS and len(shape) >= 3:
            # (B, H, S, D) per layer or (L, B, H, S, D) stacked; the batch
            # dim sits 3 ranks left of the trailing (S, D) pair for k/v
            # and 2 left for the mla latents
            b_dim = len(shape) - (4 if key in ("k", "v") else 3)
            if b_dim >= 0 and d_size > 1 and shape[b_dim] % d_size == 0:
                spec[b_dim] = data
            if seq_on_model and shape[-2] % m_size == 0:
                spec[-2] = m_axis
        return NamedSharding(mesh, P(*spec))

    return _map_with_path(one, caches)
