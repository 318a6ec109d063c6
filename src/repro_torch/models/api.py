"""Public model API: init / loss / prefill / decode over a ``Decoder``
(the JAX package's ``models/api.py``).

Each function takes the parameters either as the ``Decoder`` itself,
whose f32 masters it casts for compute on every call as the reference
does at every forward, or as the tree :func:`prepare` made once, which
``launch.serve.generate`` hands to every step so the cast is not
repeated per token.  :func:`loss_fn` casts inside the autograd graph,
so the f32 masters receive the gradients (``launch.train``).
"""
from __future__ import annotations

import torch

from . import transformer
from .layers import cross_entropy_loss, logits_out

__all__ = ["init_params", "count_params", "prepare", "loss_fn",
           "forward_logits", "prefill_step", "decode_step", "init_cache",
           "transformer_cache_tree", "pad_caches"]


def init_params(generator: torch.Generator, cfg, *, device="cuda"):
    """A ``transformer.Decoder`` on ``device`` with weights drawn from
    ``generator`` (on the same kind of device) in the reference's
    distribution.  Families other than ``dense`` and ``moe`` raise
    ``NotImplementedError``."""
    return transformer.init_decoder(generator, cfg, device=device)


def count_params(params) -> int:
    return sum(p.numel() for p in params.parameters())


STACKS = ("blocks", "dense_blocks", "moe_blocks")


def prepare(params, cfg) -> dict:
    """The parameter tree cast for compute, as the reference casts it at
    every forward: the leaves of rank >= 2 of every stacked segment
    (``blocks``, ``dense_blocks``, ``moe_blocks``: weights, the router
    and the experts, and the per-layer norm scales and biases, rank 2
    once stacked) to ``cfg.compute_dtype`` (``_prep_stack``), and the
    output projection (``lm_head``, or the tied embedding table
    transposed) as ``logits_out`` casts it.  The embedding table and the
    final norm stay f32.  A no-op copy-free tree in f32 compute."""
    if isinstance(params, dict):
        return params
    cd = transformer._cdtype(cfg)
    p = transformer.tree(params)
    for name in STACKS:
        if name in p:
            p[name] = transformer.tree_map(
                lambda a: a.to(cd) if a.ndim >= 2 and a.is_floating_point()
                else a, p[name])
    head = p["embed"]["table"].T if cfg.tie_embeddings else p["lm_head"]["w"]
    p["lm_head"] = {"w": head.to(cd)}
    return p


def _logits_fn(p, cfg):
    def f(hidden):
        lg = logits_out(p["lm_head"], hidden)
        if cfg.logit_softcap:
            lg = cfg.logit_softcap * torch.tanh(lg / cfg.logit_softcap)
        return lg
    return f


# ---------------------------------------------------------------------------
def loss_fn(params, cfg, batch):
    """batch: {"tokens": (B, S) int, "loss_mask": (B, S) opt}.  Next-token
    CE (a 0-dim f32 tensor) through the chunked loss: the label of the
    last position is 0 and masked out, ``loss_mask`` multiplies the mask,
    and the first ``cfg.vision_seq`` positions (a vision stub's) carry
    no label.  Differentiate it with ``loss.backward()`` after
    ``params.requires_grad_(True)``."""
    tokens = batch["tokens"]
    p = prepare(params, cfg)
    hidden, _ = transformer.forward(p, cfg, tokens, mode="train")
    labels = torch.cat([tokens[:, 1:], torch.zeros_like(tokens[:, :1])], 1)
    mask = torch.cat([torch.ones_like(tokens[:, 1:], dtype=torch.float32),
                      torch.zeros_like(tokens[:, :1], dtype=torch.float32)],
                     1)
    if batch.get("loss_mask") is not None:
        mask = mask * batch["loss_mask"].float()
    if cfg.vision_seq:
        vis = torch.arange(tokens.shape[1], device=tokens.device) < \
            cfg.vision_seq
        mask = mask * (~vis[None, :]).float()
    return cross_entropy_loss(_logits_fn(p, cfg), hidden, labels, mask)


def forward_logits(params, cfg, batch):
    """Full-sequence logits (small configs / tests only)."""
    p = prepare(params, cfg)
    hidden, _ = transformer.forward(p, cfg, batch["tokens"], mode="train")
    return _logits_fn(p, cfg)(hidden)


def prefill_step(params, cfg, batch):
    """Run the prompt; return (last-token logits, caches)."""
    p = prepare(params, cfg)
    hidden, caches = transformer.forward(p, cfg, batch["tokens"],
                                         mode="prefill")
    return _logits_fn(p, cfg)(hidden[:, -1:]), caches


def decode_step(params, cfg, token, caches, pos):
    """One decode step.  token: (B, 1) int; pos: int (the index this
    token occupies; the KV cache holds ``pos`` valid entries).  The
    caches are updated in place and returned."""
    p = prepare(params, cfg)
    hidden, caches = transformer.forward(p, cfg, token, mode="decode",
                                         caches=caches, pos=int(pos))
    return _logits_fn(p, cfg)(hidden), caches


# ---------------------------------------------------------------------------
def init_cache(cfg, batch: int, seq_len: int, dtype=None, *, device="cuda"):
    """Zeroed caches of the decode shape (filled by prefill in real
    serving): for the dense family {"k", "v"} of (n_layers, B,
    n_kv_heads, S, head_dim); for the MoE family one such tree per
    segment, {"dense", "moe"} ({"moe"} alone with no leading dense
    layer), each {"c_kv": (n, B, S, kv_lora_rank), "k_rope": (n, B, S,
    rope_head_dim)} under MLA."""
    transformer.require_ported(cfg)
    dt = dtype or transformer._cdtype(cfg)
    b, s = batch, seq_len

    def zeros(*shape):
        return torch.zeros(shape, dtype=dt, device=device)

    def attn_cache(n_layers):
        shape = (n_layers, b, cfg.n_kv_heads, s, cfg.head_dim)
        return {"k": zeros(*shape), "v": zeros(*shape)}

    def mla_cache(n):
        return {"c_kv": zeros(n, b, s, cfg.kv_lora_rank),
                "k_rope": zeros(n, b, s, cfg.rope_head_dim)}

    if cfg.family == "dense":
        return transformer_cache_tree(attn_cache(cfg.n_layers))
    seg_cache = mla_cache if cfg.mla else attn_cache
    out = {"moe": seg_cache(cfg.n_layers - cfg.first_dense)}
    if cfg.first_dense:
        out["dense"] = seg_cache(cfg.first_dense)
    return out


def transformer_cache_tree(c):
    return c


def pad_caches(caches, target_len: int):
    """Grow every sequence-indexed cache leaf (k/v/c_kv/k_rope, seq axis
    -2) to ``target_len`` with zeros so decode can continue past the
    prompt length."""
    def visit(name, leaf):
        if isinstance(leaf, dict):
            return {k: visit(k, v) for k, v in leaf.items()}
        if name in ("k", "v", "c_kv", "k_rope") and \
                leaf.shape[-2] < target_len:
            pad = leaf.new_zeros(leaf.shape[:-2] +
                                 (target_len - leaf.shape[-2],
                                  leaf.shape[-1]))
            return torch.cat([leaf, pad], dim=-2)
        return leaf
    return visit("", caches)
