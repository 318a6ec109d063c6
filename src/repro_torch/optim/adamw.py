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
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch
from torch import nn

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
    """Zero mu and nu in f32 on each parameter's device, step 0."""
    zeros = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                           device=p.device), _tree(params))
    device = tree_leaves(zeros)[0].device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=device),
                      mu=zeros, nu=tree_map(torch.clone, zeros))


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float):
    """Scale every gradient by ``min(1, max_norm / max(gnorm, 1e-9))``, in
    place; returns ``(grads, gnorm)``, gnorm the f32 global norm (a 0-dim
    tensor, summed leaf by leaf in the reference's order)."""
    leaves = tree_leaves(grads)
    gnorm = torch.sqrt(sum(torch.sum(g.float() ** 2) for g in leaves))
    scale = torch.clamp(max_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    for g in leaves:
        g.mul_(scale)
    return grads, gnorm


@torch.no_grad()
def adamw_update(grads, state: AdamWState, params, *, lr, b1: float = 0.9,
                 b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1):
    """One AdamW step: ``lr`` a float or 0-dim f32 tensor.  Decays only
    leaves with ``ndim >= 2`` (the stacked per-layer norm scales, (L, d),
    among them, as in the reference).  Updates ``params``, ``state.mu``
    and ``state.nu`` in place; returns ``(params, new state)``."""
    step = state.step + 1
    c1 = 1.0 - b1 ** step.float()
    c2 = 1.0 - b2 ** step.float()
    p_tree = _tree(params)
    for g, m, v, p in zip(tree_leaves(grads), tree_leaves(state.mu),
                          tree_leaves(state.nu), tree_leaves(p_tree)):
        g32 = g.float()
        m.mul_(b1).add_(g32 * (1 - b1))
        v.mul_(b2).add_((1 - b2) * g32 * g32)
        denom = (v / c2).sqrt_().add_(eps)
        update = (m / c1).div_(denom)
        if p.ndim >= 2:          # decay matrices only (norms/bias exempt)
            update.add_(torch.mul(p.float(), weight_decay, out=denom))
        p.sub_(update.mul_(lr))
    return params, AdamWState(step=step, mu=state.mu, nu=state.nu)
