"""Architecture assembly for the dense, MoE and VLM decoder-only
families (the JAX package's ``models/transformer.py``).

The block parameters are stacked on a leading layer axis, as the
reference's ``_stack_init`` stacks them, and the reference's ``lax.scan``
over that axis is a Python loop over the layers, each under
:func:`_remat` in training (``cfg.remat``, ``cfg.remat_policy``), the
counterpart of the reference's ``jax.checkpoint``.  The MoE family runs
two segments, ``dense_blocks`` (the leading dense layers, deepseek's
first) and ``moe_blocks``, each block with MLA attention when
``cfg.mla`` is set.  The VLM family (Qwen2-VL) is the dense stack with
M-RoPE and a vision splice: precomputed patch embeddings
(``vision_embeds``) replace the first positions of the token embeddings
(:func:`_embed_tokens`).  The other families (``hybrid``, ``ssm``,
``audio``) raise ``NotImplementedError`` naming their ROADMAP item.
"""
from __future__ import annotations

import functools
from typing import Any

import torch
from torch import nn
from torch.utils.checkpoint import (checkpoint,
                                    create_selective_checkpoint_contexts,
                                    noop_context_fn)

from . import attention as attn_mod
from . import mla as mla_mod
from . import moe as moe_mod
from .layers import FFN, Embedding, Linear, Norm, draw, embed, ffn, norm

PORTED = ("dense", "moe", "vlm")
_NOT_PORTED = {
    "hybrid": "ROADMAP queue 1 item 12 (the hybrid Mamba2 family)",
    "ssm": "ROADMAP queue 1 item 12 (the xLSTM family)",
    "audio": "ROADMAP queue 1 item 12 (the encoder-decoder family)",
}


def require_ported(cfg) -> None:
    """Raise ``NotImplementedError`` for a family the port lacks."""
    if cfg.family not in PORTED:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family!r} family is not ported yet; see "
            f"{_NOT_PORTED.get(cfg.family, 'ROADMAP queue 1 item 12')}")


def _cdtype(cfg) -> torch.dtype:
    return getattr(torch, cfg.compute_dtype)


# ---------------------------------------------------------------------------
# the standard pre-norm attention block
class Block(nn.Module):
    """``init_block``: ln1, attn (``MLA`` when ``cfg.mla`` is set), ln2
    (absent for a parallel block), and ``moe`` for a MoE layer or else
    ``ffn`` (of width ``d_ff``, ``cfg.d_ff`` by default); stacked on a
    leading axis of ``layers``."""

    def __init__(self, cfg, *, moe_layer: bool = False,
                 d_ff: int | None = None, layers: int | None = None,
                 device=None):
        super().__init__()
        kw = dict(layers=layers, device=device)
        self.ln1 = Norm(cfg.d_model, cfg.norm, **kw)
        self.attn = mla_mod.MLA(cfg, **kw) if cfg.mla \
            else attn_mod.Attention(cfg, **kw)
        if not cfg.parallel_block:
            self.ln2 = Norm(cfg.d_model, cfg.norm, **kw)
        if moe_layer:
            self.moe = moe_mod.MoE(cfg, **kw)
        else:
            self.ffn = FFN(cfg.d_model, d_ff or cfg.d_ff, cfg.act, **kw)


def init_block(generator, cfg, *, moe_layer: bool = False,
               d_ff: int | None = None, layers: int | None = None,
               device=None) -> Block:
    return draw(Block(cfg, moe_layer=moe_layer, d_ff=d_ff, layers=layers,
                      device=device), generator)


def _block_mix(p, h, cfg, positions, mode, cache, pos):
    """The attention (or MLA) sub-layer in the given mode."""
    if cfg.mla:
        if mode == "train":
            return mla_mod.mla_train(p["attn"], h, cfg, positions), None
        if mode == "prefill":
            return mla_mod.mla_prefill(p["attn"], h, cfg, positions)
        return mla_mod.mla_decode(p["attn"], h, cfg, cache, pos)
    if mode == "train":
        return attn_mod.attention_train(p["attn"], h, cfg, positions), None
    if mode == "prefill":
        return attn_mod.attention_prefill(p["attn"], h, cfg, positions)
    return attn_mod.attention_decode(p["attn"], h, cfg, cache, pos)


def block_apply(p, x, cfg, positions, *, moe_layer: bool = False,
                mode: str = "train", cache=None, pos=None):
    """Returns (x, new_cache)."""
    def mlp(h):
        return moe_mod.moe_ffn(p["moe"], h, cfg) if moe_layer \
            else ffn(p["ffn"], h, cfg.act)

    if cfg.parallel_block:                 # command-r style
        h = norm(p["ln1"], x, cfg.norm, cfg.norm_eps)
        a, new_cache = _block_mix(p, h, cfg, positions, mode, cache, pos)
        return x + a + mlp(h), new_cache
    h = norm(p["ln1"], x, cfg.norm, cfg.norm_eps)
    a, new_cache = _block_mix(p, h, cfg, positions, mode, cache, pos)
    x = x + a
    h = norm(p["ln2"], x, cfg.norm, cfg.norm_eps)
    return x + mlp(h), new_cache


# ---------------------------------------------------------------------------
# segments: (kind, count) derived from the config
def segments(cfg) -> list[tuple[str, int]]:
    if cfg.family in ("dense", "vlm"):
        return [("block", cfg.n_layers)]
    if cfg.family == "moe":
        segs = []
        if cfg.first_dense:
            segs.append(("dense_block", cfg.first_dense))
        segs.append(("moe_block", cfg.n_layers - cfg.first_dense))
        return segs
    if cfg.family == "hybrid":          # zamba2
        return [("zamba", cfg.n_layers)]
    if cfg.family == "ssm":             # xlstm
        return [("xlstm", cfg.n_layers)]
    if cfg.family == "audio":
        return [("whisper", cfg.n_layers)]
    raise ValueError(cfg.family)


# ---------------------------------------------------------------------------
class Decoder(nn.Module):
    """The parameter tree of ``init_decoder``: ``embed``, ``final_norm``,
    ``lm_head`` (absent when the embeddings are tied) and, for the dense
    and VLM families, ``blocks`` stacked over ``n_layers``; for the MoE
    family, ``dense_blocks`` stacked over ``first_dense`` (FFN width
    ``first_dense_ff``; absent when there are none) and ``moe_blocks``
    over the rest.  Its ``state_dict`` keys are the reference's pytree
    paths joined by dots."""

    def __init__(self, cfg, *, device=None):
        super().__init__()
        require_ported(cfg)
        self.embed = Embedding(cfg.padded_vocab, cfg.d_model, device=device)
        self.final_norm = Norm(cfg.d_model, cfg.norm, device=device)
        if not cfg.tie_embeddings:
            self.lm_head = Linear(cfg.d_model, cfg.padded_vocab,
                                  device=device)
        if cfg.family in ("dense", "vlm"):
            self.blocks = Block(cfg, layers=cfg.n_layers, device=device)
            return
        if cfg.first_dense:
            self.dense_blocks = Block(cfg, d_ff=cfg.first_dense_ff,
                                      layers=cfg.first_dense, device=device)
        self.moe_blocks = Block(cfg, moe_layer=True,
                                layers=cfg.n_layers - cfg.first_dense,
                                device=device)


def init_decoder(generator, cfg, *, device=None) -> Decoder:
    """A ``Decoder`` with weights drawn from ``generator`` (on ``device``,
    the generator's device by default)."""
    return draw(Decoder(cfg, device=device or generator.device), generator)


def tree(module: nn.Module) -> dict[str, Any]:
    """The module's tensors as nested dicts keyed by the reference's
    pytree path components."""
    out: dict[str, Any] = {}
    for name, t in module.named_parameters():
        *path, leaf = name.split(".")
        node = out
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = t
    return out


def tree_map(fn, t):
    """``fn`` over the leaves of a nested dict (or over ``t`` itself when
    it is not a dict)."""
    if not isinstance(t, dict):
        return fn(t)
    return {k: tree_map(fn, v) for k, v in t.items()}


def tree_leaves(t) -> list:
    """The leaves of a nested dict in the reference's pytree order (keys
    sorted at every level, as ``jax.tree_util`` sorts dict keys)."""
    if not isinstance(t, dict):
        return [t]
    return [leaf for k in sorted(t) for leaf in tree_leaves(t[k])]


def _positions(tokens_shape, offset=0, device=None):
    _, s = tokens_shape
    return torch.arange(s, dtype=torch.int32, device=device)[None, :] + \
        offset


# ---------------------------------------------------------------------------
def _embed_tokens(p, cfg, tokens, vision_embeds=None):
    """The token embeddings in the compute dtype; with ``vision_embeds``
    (B, nv, d) and ``cfg.vision_seq`` set, the first ``nv`` positions are
    the vision embeddings instead (a new tensor, concatenated as the
    reference concatenates)."""
    x = embed(p["embed"], tokens,
              scale=cfg.d_model ** 0.5 if cfg.embed_scale else None)
    x = x.to(_cdtype(cfg))
    if vision_embeds is not None and cfg.vision_seq:
        nv = vision_embeds.shape[1]
        x = torch.cat([vision_embeds.to(x.dtype), x[:, nv:]], 1)
    return x


def forward(p, cfg, tokens, *, vision_embeds=None, mode: str = "train",
            caches=None, pos=None):
    """Unified entry over a parameter tree already cast for compute
    (``api.prepare``).  Returns (hidden, caches):

    * train:   hidden (B, S, d), caches None
    * prefill: hidden (B, S, d), fresh caches
    * decode:  hidden (B, 1, d), caches updated in place  (pos: int index)

    ``vision_embeds`` (B, nv, d), the VLM family's stub of patch
    embeddings, replaces the first ``nv`` positions in train and prefill;
    decode takes none.  The MoE family's caches are ``{"dense", "moe"}``,
    one per segment, or ``{"moe"}`` alone when it has no leading dense
    layer.
    """
    require_ported(cfg)
    x = _embed_tokens(p, cfg, tokens, vision_embeds)
    positions = _positions(tokens.shape, device=tokens.device) \
        if mode != "decode" else None
    if cfg.family in ("dense", "vlm"):
        x, out_caches = _run_attn_stack(p["blocks"], x, cfg, positions,
                                        mode, caches, pos, moe_layer=False)
    else:
        out_caches = {}
        if cfg.first_dense:
            x, out_caches["dense"] = _run_attn_stack(
                p["dense_blocks"], x, cfg, positions, mode,
                caches and caches.get("dense"), pos, moe_layer=False)
        x, out_caches["moe"] = _run_attn_stack(
            p["moe_blocks"], x, cfg, positions, mode,
            caches and caches.get("moe"), pos, moe_layer=True)
    x = norm(p["final_norm"], x, cfg.norm, cfg.norm_eps)
    return x, out_caches


# the non-batched matrix products (``x @ w``: aten.mm, or aten.addmm with
# a bias), the outputs ``dots_with_no_batch_dims_saveable`` keeps
_DOTS = [torch.ops.aten.mm.default, torch.ops.aten.addmm.default]


def _remat(f, cfg):
    """``f`` as the reference's ``_remat`` wraps it: unchanged when
    ``cfg.remat`` is off; under ``torch.utils.checkpoint`` (everything
    recomputed in the backward pass) for ``remat_policy="full"``; for
    ``"dots"`` a selective checkpoint that keeps the outputs of the
    non-batched matrix products and recomputes the rest.  The values do
    not depend on the policy, only what the backward pass recomputes."""
    if not cfg.remat:
        return f
    context_fn = functools.partial(create_selective_checkpoint_contexts,
                                   _DOTS) \
        if cfg.remat_policy == "dots" else noop_context_fn

    def g(*args):
        return checkpoint(f, *args, use_reentrant=False,
                          context_fn=context_fn)
    return g


def _unstack(stacked) -> list[dict]:
    """One parameter tree per layer, views of the stacked leaves (one
    ``unbind`` a leaf, so the backward pass stacks the layers' gradients
    once)."""
    cols = tree_map(lambda a: a.unbind(0), stacked)
    n = stacked["ln1"]["scale"].shape[0]
    return [tree_map(lambda c: c[i], cols) for i in range(n)]


def _run_attn_stack(stacked, x, cfg, positions, mode, caches, pos, *,
                    moe_layer: bool):
    layers = _unstack(stacked)
    if mode == "train":
        def body(h, p_l):
            return block_apply(p_l, h, cfg, positions, moe_layer=moe_layer,
                               mode="train")[0]
        f = _remat(body, cfg)
        for p_l in layers:
            x = f(x, p_l)
        return x, None
    if mode == "prefill":
        # whatever cache leaves the block returns (k/v, or c_kv/k_rope),
        # stacked over the layers
        collected: dict[str, list] = {}
        for p_l in layers:
            x, c = block_apply(p_l, x, cfg, positions, moe_layer=moe_layer,
                               mode="prefill")
            for name, leaf in c.items():
                collected.setdefault(name, []).append(leaf)
        return x, {name: torch.stack(leaves)
                   for name, leaves in collected.items()}
    for i, p_l in enumerate(layers):
        x, _ = block_apply(p_l, x, cfg, None, moe_layer=moe_layer,
                           mode="decode",
                           cache={name: leaf[i]
                                  for name, leaf in caches.items()},
                           pos=pos)
    return x, caches
