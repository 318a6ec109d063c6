"""Shared layers: norms, linears, FFN variants, embeddings, the loss.

The parameter containers are ``nn.Module``s whose parameter names are the
JAX package's pytree keys (``w``/``b``, ``scale``/``bias``, ``table``),
with a leading layer axis when ``layers`` is given (the stacked blocks).
Each draws its weights with :meth:`reset_parameters` from an explicit
``torch.Generator``, in the reference's distribution.  The functions
(:func:`linear`, :func:`norm`, :func:`ffn`, :func:`embed`,
:func:`logits_out`) take the parameters as nested dicts of tensors, as
the reference's take pytrees.  :func:`cross_entropy_loss` is the
training loss.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

__all__ = ["Linear", "Norm", "FFN", "Embedding", "draw", "linear", "norm",
           "ffn", "embed", "logits_out", "cross_entropy_loss"]


def _param(shape, device) -> nn.Parameter:
    # created without gradients, so serving never records a graph (and
    # the flash kernel, which has no backward, takes the activations);
    # the trainer turns them on (``launch.train``: requires_grad_(True))
    return nn.Parameter(torch.empty(shape, dtype=torch.float32,
                                    device=device), requires_grad=False)


def _lead(layers: int | None) -> tuple:
    return () if layers is None else (layers,)


# -- parameter containers -----------------------------------------------------
class Linear(nn.Module):
    """``init_linear``: ``w`` (d_in, d_out), truncated normal in [-2, 2]
    times ``d_in ** -0.5``; optional zero bias ``b``."""

    def __init__(self, d_in: int, d_out: int, *, bias: bool = False,
                 layers: int | None = None, device=None):
        super().__init__()
        self.w = _param(_lead(layers) + (d_in, d_out), device)
        self.b = _param(_lead(layers) + (d_out,), device) if bias else None

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        nn.init.trunc_normal_(self.w, 0.0, 1.0, -2.0, 2.0,
                              generator=generator).mul_(self.w.shape[-2] **
                                                        -0.5)
        if self.b is not None:
            self.b.zero_()


class Norm(nn.Module):
    """``init_norm``: ``scale`` ones, and ``bias`` zeros for layernorm."""

    def __init__(self, d: int, kind: str = "rmsnorm", *,
                 layers: int | None = None, device=None):
        super().__init__()
        self.scale = _param(_lead(layers) + (d,), device)
        self.bias = _param(_lead(layers) + (d,), device) \
            if kind == "layernorm" else None

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        self.scale.fill_(1.0)
        if self.bias is not None:
            self.bias.zero_()


class FFN(nn.Module):
    """``init_ffn``: gate/up/down for swiglu, up/down for gelu and relu2."""

    def __init__(self, d_model: int, d_ff: int, act: str, *,
                 layers: int | None = None, device=None):
        super().__init__()
        if act == "swiglu":
            self.gate = Linear(d_model, d_ff, layers=layers, device=device)
        self.up = Linear(d_model, d_ff, layers=layers, device=device)
        self.down = Linear(d_ff, d_model, layers=layers, device=device)


class Embedding(nn.Module):
    """``init_embedding``: ``table`` (vocab, d_model) ~ N(0, 0.02^2)."""

    def __init__(self, vocab: int, d_model: int, *, device=None):
        super().__init__()
        self.table = _param((vocab, d_model), device)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        self.table.normal_(0.0, 0.02, generator=generator)


def draw(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Draw every parameter of ``module`` from ``generator``, submodule by
    submodule in registration order; returns ``module``."""
    device = next(module.parameters()).device
    if generator.device.type != device.type:
        raise ValueError(f"generator on {generator.device}, parameters on "
                         f"{device}")
    for m in module.modules():
        if isinstance(m, (Linear, Norm, Embedding)):
            m.reset_parameters(generator)
    return module


# -- functions over parameter dicts -------------------------------------------
def linear(p, x):
    y = x @ p["w"].to(x.dtype)
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


def norm(p, x, kind: str = "rmsnorm", eps: float = 1e-5):
    xf = x.float()
    if kind == "rmsnorm":
        xf = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    elif kind == "layernorm":
        mu = xf.mean(-1, keepdim=True)
        var = xf.var(-1, keepdim=True, correction=0)   # jnp.var
        xf = (xf - mu) * torch.rsqrt(var + eps)
    else:
        raise ValueError(kind)
    y = xf * p["scale"].float()
    if "bias" in p:
        y = y + p["bias"].float()
    return y.to(x.dtype)


def ffn(p, x, act: str):
    if act == "swiglu":
        h = F.silu(linear(p["gate"], x)) * linear(p["up"], x)
    elif act == "gelu":
        h = F.gelu(linear(p["up"], x), approximate="tanh")
    elif act == "relu2":                      # Nemotron squared-ReLU
        h = torch.square(F.relu(linear(p["up"], x)))
    else:
        raise ValueError(act)
    return linear(p["down"], h)


def embed(p, tokens, scale: float | None = None):
    e = F.embedding(tokens, p["table"])
    if scale is not None:
        e = e * scale
    return e


def logits_out(p_head, x, *, tied_table=None, scale: float | None = None):
    """Project hidden states to the (padded) vocabulary."""
    w = tied_table.T if tied_table is not None else p_head["w"]
    y = x @ w.to(x.dtype)
    if scale is not None:
        y = y * scale
    return y


# -- loss ------------------------------------------------------------------------
def cross_entropy_loss(logits_fn, hidden, labels, mask, *,
                       chunk: int = 1024):
    """Next-token CE computed in sequence chunks so the (B, S, V) logits
    tensor never materializes (vital for 100k+ vocabularies).

    ``logits_fn``: hidden chunk (B, c, D) -> logits (B, c, V).
    ``labels``/``mask``: (B, S) int / float.  ``chunk`` becomes S when it
    does not divide S, as in the reference.  Each chunk runs under
    ``torch.utils.checkpoint`` (the reference's ``jax.checkpoint``): its
    (B, c, V) logits are recomputed in the backward pass instead of
    being kept once per chunk.  The logsumexp and the gold logit are
    taken in f32.
    """
    _, s, _ = hidden.shape
    chunk = min(chunk, s)
    if s % chunk:
        chunk = s

    def body(h, y, m):
        lg = logits_fn(h).float()                        # (B, c, V)
        lse = torch.logsumexp(lg, dim=-1)
        gold = lg.gather(-1, y[..., None].long())[..., 0]
        return ((lse - gold) * m).sum()

    tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
    cnt = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(0, s, chunk):
        m = mask[:, i:i + chunk]
        tot = tot + checkpoint(body, hidden[:, i:i + chunk],
                               labels[:, i:i + chunk], m, use_reentrant=False)
        cnt = cnt + m.sum()
    return tot / torch.clamp(cnt, min=1.0)
