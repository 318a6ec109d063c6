"""AdamW with decoupled weight decay, f32 master statistics (the JAX
package's ``optim/adamw.py``).

The state is ``AdamWState(step, mu, nu)``: a 0-dim int32 step and two
trees of f32 tensors with the parameter tree's keys.  The parameters are
a ``Decoder`` (its tree, ``models.transformer.tree``) or a nested dict
of tensors, and the gradients a nested dict with the same keys.  Where
the reference returns new trees, :func:`clip_by_global_norm` and
:func:`adamw_update` write the gradients, the parameters, mu and nu in
place (12-byte-a-parameter trees that a step must not copy) and return
them; every operation is the reference's, in its order, in f32.  This
is the reference's update, not ``torch.optim.AdamW``, which places
``eps``, the weight decay and the step counter differently.

Placed leaves (``repro_torch.dist.Placed``, the trainer under a mesh):
mu and nu are laid out like the parameters and the step is replicated
(``dist.sharding.opt_state_shardings``), every device updates its own
chunks, replicas included, and the global norm sums each distinct chunk
once (the reference's ``psum`` over the shards, in another order).
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch
from torch import nn

from .. import dist
from ..models.transformer import tree, tree_leaves, tree_map

__all__ = ["AdamWState", "adamw_init", "clip_by_global_norm",
           "adamw_update"]


class AdamWState(NamedTuple):
    step: Any
    mu: Any
    nu: Any


def _tree(params) -> dict:
    return tree(params) if isinstance(params, nn.Module) else params


def adamw_init(params) -> AdamWState:
    """Zero mu and nu in f32 on each parameter's device (placed like each
    placed parameter, the step then replicated over its mesh), step 0."""
    def zeros(p):
        if isinstance(p, dist.Placed):
            return p.map(lambda t: torch.zeros(t.shape, dtype=torch.float32,
                                               device=t.device))
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    mu = tree_map(zeros, _tree(params))
    first = tree_leaves(mu)[0]
    if isinstance(first, dist.Placed):
        step = dist.device_put(torch.zeros((), dtype=torch.int32),
                               dist.NamedSharding(first.sharding.mesh,
                                                  dist.PartitionSpec()))
    else:
        step = torch.zeros((), dtype=torch.int32, device=first.device)
    return AdamWState(step=step, mu=mu, nu=tree_map(zeros, mu))


def _chunks(x) -> list:
    """Every chunk a device holds: a placed leaf's, or the tensor."""
    return list(x.shards.values()) if isinstance(x, dist.Placed) else [x]


def _distinct(x) -> list:
    """Each distinct chunk once: a placed leaf's, or the tensor."""
    if not isinstance(x, dist.Placed):
        return [x]
    return [x.shards[dev] for _, dev in x.distinct()]


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float):
    """Scale every gradient by ``min(1, max_norm / max(gnorm, 1e-9))``, in
    place; returns ``(grads, gnorm)``, gnorm the f32 global norm (a 0-dim
    tensor, summed leaf by leaf in the reference's order; a placed leaf's
    distinct chunks in mesh order, on the first leaf's device)."""
    leaves = tree_leaves(grads)
    dev = _chunks(leaves[0])[0].device
    gnorm = torch.sqrt(sum(torch.sum(c.float() ** 2).to(dev)
                           for g in leaves for c in _distinct(g)))
    scale = torch.clamp(max_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    for g in leaves:
        for c in _chunks(g):
            c.mul_(scale.to(c.device))
    return grads, gnorm


@torch.no_grad()
def adamw_update(grads, state: AdamWState, params, *, lr, b1: float = 0.9,
                 b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1):
    """One AdamW step: ``lr`` a float or 0-dim f32 tensor.  Decays only
    leaves with ``ndim >= 2`` (the stacked per-layer norm scales, (L, d),
    among them, as in the reference).  Updates ``params``, ``state.mu``
    and ``state.nu`` in place; returns ``(params, new state)``."""
    step = state.step.map(lambda t: t + 1) \
        if isinstance(state.step, dist.Placed) else state.step + 1
    p_tree = _tree(params)
    for g, m, v, p in zip(tree_leaves(grads), tree_leaves(state.mu),
                          tree_leaves(state.nu), tree_leaves(p_tree)):
        # decay matrices only (norms/bias exempt)
        decay = weight_decay if p.ndim >= 2 else None
        if not isinstance(p, dist.Placed):
            _update(g, m, v, p, _step_on(step, None), lr, b1, b2, eps,
                    decay)
            continue
        for dev, pc in p.shards.items():
            _update(g.shards[dev], m.shards[dev], v.shards[dev], pc,
                    _step_on(step, dev), lr, b1, b2, eps, decay)
    return params, AdamWState(step=step, mu=state.mu, nu=state.nu)


def _step_on(step, dev):
    """The step as ``dev`` holds it (its chunk of a placed step)."""
    return step.shards[dev] if isinstance(step, dist.Placed) else step


def _update(g, m, v, p, step, lr, b1, b2, eps, decay) -> None:
    """One leaf's (or one chunk's) AdamW update, in place."""
    c1 = 1.0 - b1 ** step.float()
    c2 = 1.0 - b2 ** step.float()
    g32 = g.float()
    m.mul_(b1).add_(g32 * (1 - b1))
    v.mul_(b2).add_((1 - b2) * g32 * g32)
    denom = (v / c2).sqrt_().add_(eps)
    update = (m / c1).div_(denom)
    if decay is not None:
        update.add_(torch.mul(p.float(), decay, out=denom))
    p.sub_(update.mul_(lr))
