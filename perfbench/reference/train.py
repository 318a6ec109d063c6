"""The plain reference's training steps: the loss of
:func:`perfbench.reference.model.loss`, its gradient by autograd, the
global-norm clip, a cosine schedule with linear warm-up and AdamW with
decoupled weight decay on every leaf of two or more dimensions, all in
float32 (or in the control's precision, for the products).

The optimizer's settings are the configuration file's ``train`` block.
"""
from __future__ import annotations

import math

import torch

from . import model

__all__ = ["lr_at", "run_steps"]


def lr_at(step: int, hp: dict) -> float:
    """Linear warm-up to ``peak_lr`` over ``warmup`` steps, then a cosine
    decay to ``min_lr_ratio * peak_lr`` at ``total_steps``."""
    peak, warm, total = hp["peak_lr"], hp["warmup"], hp["total_steps"]
    if step < warm:
        return peak * step / max(warm, 1)
    prog = min(max((step - warm) / max(total - warm, 1), 0.0), 1.0)
    return peak * (hp["min_lr_ratio"] + (1 - hp["min_lr_ratio"]) * 0.5 *
                   (1 + math.cos(math.pi * prog)))


def run_steps(w: dict, dims: model.Dims, batches, steps, hp: dict,
              ar: model.Arith) -> dict:
    """Train ``w`` (``{name: f32 tensor}``, updated in place) on
    ``batches`` (token tensors (B, S)), the k-th at schedule step
    ``steps[k]``.  Returns ``{"loss": [...], "first_grad": {name:
    norm}}``: each step's loss and, per leaf, the norm of the first
    step's gradient after the clip, as the optimizer takes it."""
    b1, b2, eps = hp["b1"], hp["b2"], hp["eps"]
    mu = {n: torch.zeros_like(p) for n, p in w.items()}
    nu = {n: torch.zeros_like(p) for n, p in w.items()}
    losses, first = [], None
    for t, (tokens, step) in enumerate(zip(batches, steps), start=1):
        for p in w.values():
            p.grad = None
            p.requires_grad_(True)
        lo = model.loss(w, dims, tokens, ar)
        lo.backward()
        losses.append(float(lo.detach()))
        with torch.no_grad():
            grads = {n: p.grad for n, p in w.items()}
            gnorm = torch.sqrt(sum((g * g).sum() for g in grads.values()))
            scale = min(1.0, hp["clip"] / max(float(gnorm), 1e-9))
            lr = lr_at(step, hp)
            c1, c2 = 1 - b1 ** t, 1 - b2 ** t
            for n, p in w.items():
                g = grads[n].mul_(scale)
                mu[n].mul_(b1).add_(g, alpha=1 - b1)
                nu[n].mul_(b2).addcmul_(g, g, value=1 - b2)
                upd = (mu[n] / c1) / ((nu[n] / c2).sqrt_().add_(eps))
                if p.ndim >= 2:
                    upd.add_(p, alpha=hp["weight_decay"])
                p.sub_(upd.mul_(lr))
            if first is None:
                first = {n: float(g.norm()) for n, g in grads.items()}
        for p in w.values():
            p.grad = None
            p.requires_grad_(False)
    return {"loss": losses, "first_grad": first}
