"""Architecture assembly for the dense, MoE, VLM, hybrid (Zamba2),
xLSTM and encoder-decoder (whisper) stacks (the JAX package's
``models/transformer.py``).

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
(:func:`_embed_tokens`).  The hybrid family (Zamba2) runs segments of
stacked Mamba2 blocks with one shared attention block before each
segment after the first (:func:`_zamba_forward`); the ``ssm`` family
(xLSTM) runs repeats of stacked mLSTM blocks each followed by one sLSTM
block (:func:`_xlstm_forward`).  Their caches are per-segment lists of
f32 states.  The encoder-decoder family (``audio``, whisper) encodes
precomputed frame embeddings (``enc_frames``, the conv front end's
stub) with non-causal blocks and runs a causal decoder whose every
layer cross-attends to the encoder output (:func:`_whisper_forward`).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any

import torch
from torch import nn
from torch.utils.checkpoint import (checkpoint,
                                    create_selective_checkpoint_contexts,
                                    noop_context_fn)

from . import attention as attn_mod
from . import mamba as mamba_mod
from . import mla as mla_mod
from . import moe as moe_mod
from . import xlstm as xlstm_mod
from .layers import (FFN, Embedding, Linear, Norm, draw, embed, ffn, linear,
                     norm)
from .rope import sinusoidal_position_at, sinusoidal_positions

PORTED = ("dense", "moe", "vlm", "hybrid", "ssm", "audio")


def require_ported(cfg) -> None:
    """Raise ``NotImplementedError`` for a family the port lacks (every
    family of ``configs.ARCH_IDS`` is ported)."""
    if cfg.family not in PORTED:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family!r} family is not ported")


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


class WhisperDecBlock(nn.Module):
    """``_init_whisper_dec_block``: ln1, attn (causal self-attention),
    ln_x, xattn (cross-attention to the encoder output), ln2, ffn;
    stacked on a leading axis of ``layers``."""

    def __init__(self, cfg, *, layers: int | None = None, device=None):
        super().__init__()
        kw = dict(layers=layers, device=device)
        self.ln1 = Norm(cfg.d_model, cfg.norm, **kw)
        self.attn = attn_mod.Attention(cfg, **kw)
        self.ln_x = Norm(cfg.d_model, cfg.norm, **kw)
        self.xattn = attn_mod.Attention(cfg, **kw)
        self.ln2 = Norm(cfg.d_model, cfg.norm, **kw)
        self.ffn = FFN(cfg.d_model, cfg.d_ff, cfg.act, **kw)


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


def _zamba_attn_positions(cfg) -> list[int]:
    """Mamba-layer indices before which the shared attention block runs."""
    return [i for i in range(cfg.attn_every, cfg.n_layers, cfg.attn_every)]


def _xlstm_slstm_count(cfg) -> int:
    return cfg.n_layers // cfg.slstm_every if cfg.slstm_every else 0


# ---------------------------------------------------------------------------
class Decoder(nn.Module):
    """The parameter tree of ``init_decoder``: ``embed``, ``final_norm``,
    ``lm_head`` (absent when the embeddings are tied) and, for the dense
    and VLM families, ``blocks`` stacked over ``n_layers``; for the MoE
    family, ``dense_blocks`` stacked over ``first_dense`` (FFN width
    ``first_dense_ff``; absent when there are none) and ``moe_blocks``
    over the rest; for the hybrid family, ``mamba`` stacked over
    ``n_layers``, ``shared_in`` (2d -> d) and one unstacked
    ``shared_attn`` block; for the ``ssm`` family, ``mlstm`` stacked over
    the layers that are not sLSTM and ``slstm`` over the
    ``n_layers // slstm_every`` that are (absent when there are none);
    for the ``audio`` family, ``enc_blocks`` (blocks without rotary
    positions) stacked over ``encoder_layers``, ``enc_norm`` and
    ``dec_blocks`` (``WhisperDecBlock``) stacked over ``n_layers``.
    Its ``state_dict`` keys are the reference's pytree paths joined by
    dots."""

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
        if cfg.family == "hybrid":
            self.mamba = mamba_mod.Mamba(cfg, layers=cfg.n_layers,
                                         device=device)
            # one shared attention block and its 2d -> d input projection
            self.shared_in = Linear(2 * cfg.d_model, cfg.d_model,
                                    device=device)
            self.shared_attn = Block(cfg, device=device)
            return
        if cfg.family == "ssm":
            n_s = _xlstm_slstm_count(cfg)
            self.mlstm = xlstm_mod.MLSTM(cfg, layers=cfg.n_layers - n_s,
                                         device=device)
            if n_s:
                self.slstm = xlstm_mod.SLSTM(cfg, layers=n_s, device=device)
            return
        if cfg.family == "audio":
            self.enc_blocks = Block(dataclasses.replace(cfg,
                                                        rope_type="none"),
                                    layers=cfg.encoder_layers, device=device)
            self.enc_norm = Norm(cfg.d_model, cfg.norm, device=device)
            self.dec_blocks = WhisperDecBlock(cfg, layers=cfg.n_layers,
                                              device=device)
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


def forward(p, cfg, tokens, *, vision_embeds=None, enc_frames=None,
            mode: str = "train", caches=None, pos=None):
    """Unified entry over a parameter tree already cast for compute
    (``api.prepare``).  Returns (hidden, caches):

    * train:   hidden (B, S, d), caches None
    * prefill: hidden (B, S, d), fresh caches
    * decode:  hidden (B, 1, d), caches updated in place  (pos: int index)

    ``vision_embeds`` (B, nv, d), the VLM family's stub of patch
    embeddings, replaces the first ``nv`` positions in train and prefill;
    decode takes none.  The MoE family's caches are ``{"dense", "moe"}``,
    one per segment, or ``{"moe"}`` alone when it has no leading dense
    layer; the hybrid and ``ssm`` families' are ``api.init_cache``'s
    per-segment lists, their stacked states written in place in decode.
    ``enc_frames`` (B, S_enc, d), the ``audio`` family's precomputed
    frame embeddings, is encoded in train and prefill; its caches are
    ``{"self": {"k", "v"}, "enc_out"}``, the encoder output carried into
    decode.
    """
    require_ported(cfg)
    if cfg.family == "audio":
        return _whisper_forward(p, cfg, tokens, enc_frames, mode, caches,
                                pos)
    x = _embed_tokens(p, cfg, tokens, vision_embeds)
    positions = _positions(tokens.shape, device=tokens.device) \
        if mode != "decode" else None
    if cfg.family in ("dense", "vlm"):
        x, out_caches = _run_attn_stack(p["blocks"], x, cfg, positions,
                                        mode, caches, pos, moe_layer=False)
    elif cfg.family == "hybrid":
        x, out_caches = _zamba_forward(p, cfg, x, positions, mode, caches,
                                       pos)
    elif cfg.family == "ssm":
        x, out_caches = _xlstm_forward(p, cfg, x, mode, caches)
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
    n = len(tree_leaves(cols)[0])
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


# ---------------------------------------------------------------------------
def _zamba_forward(p, cfg, x, positions, mode, caches, pos):
    """The Mamba2 stack in segments split at ``_zamba_attn_positions``;
    before every segment but the first the shared attention block runs
    on ``shared_in(cat(hidden, embeddings))``, its own residual stream
    becoming the hidden state, with a cache of its own per call site.  A
    Mamba2 block has no input norm and no residual: its output replaces
    the hidden state.  In decode the segments' stacked states are
    written in place."""
    x0 = x
    bounds = [0] + _zamba_attn_positions(cfg) + [cfg.n_layers]
    layers = _unstack(p["mamba"])
    new: dict[str, list] = {"mamba": [], "conv": [], "attn": []}

    def mamba_train(h, p_l):
        return mamba_mod.mamba_chunked(p_l, h, cfg)
    mamba_train = _remat(mamba_train, cfg)

    for si in range(len(bounds) - 1):
        if si > 0:
            h = linear(p["shared_in"], torch.cat([x, x0], -1))
            x, c = block_apply(p["shared_attn"], h, cfg, positions,
                               mode=mode, pos=pos,
                               cache=caches["attn"][si - 1]
                               if mode == "decode" else None)
            new["attn"].append(c)
        seg = layers[bounds[si]:bounds[si + 1]]
        if mode == "train":
            for p_l in seg:
                x = mamba_train(x, p_l)
        elif mode == "prefill":
            sts, css = [], []
            for p_l in seg:
                x, st, cs = mamba_mod.mamba_chunked(p_l, x, cfg,
                                                    return_state=True)
                sts.append(st)
                css.append(cs)
            new["mamba"].append(torch.stack(sts))
            new["conv"].append(torch.stack(css))
        else:
            sts, css = caches["mamba"][si], caches["conv"][si]
            for i, p_l in enumerate(seg):
                x, st, cs = mamba_mod.mamba_decode(p_l, x, cfg, sts[i],
                                                   css[i])
                sts[i].copy_(st)
                css[i].copy_(cs)
            new["mamba"].append(sts)
            new["conv"].append(css)
    return x, (None if mode == "train" else new)


def _xlstm_forward(p, cfg, x, mode, caches):
    """Repeats of (slstm_every - 1) stacked mLSTM blocks and one sLSTM
    block (the mLSTM blocks alone when there is no sLSTM), each block
    inside a residual.  Caches: ``mlstm`` a list of (C, n, m) stacked over
    a repeat's layers, ``mconv`` their conv states, ``slstm`` a list of
    (c, n, m, h); in decode the mLSTM states are written in place."""
    n_s = _xlstm_slstm_count(cfg)
    per = (cfg.slstm_every - 1) if n_s else cfg.n_layers
    n_m = cfg.n_layers - n_s
    mlayers = _unstack(p["mlstm"])
    slayers = _unstack(p["slstm"]) if n_s else []
    new: dict[str, list] = {"mlstm": [], "mconv": [], "slstm": []}

    def mlstm_train(h, p_l):
        return h + xlstm_mod.mlstm_chunked(p_l, h, cfg)
    mlstm_train = _remat(mlstm_train, cfg)

    for r in range(n_s if n_s else 1):
        seg = mlayers[r * per:min((r + 1) * per, n_m)]
        if mode == "train":
            for p_l in seg:
                x = mlstm_train(x, p_l)
        elif mode == "prefill":
            sts, css = [], []
            for p_l in seg:
                out, st, cs = xlstm_mod.mlstm_chunked(p_l, x, cfg,
                                                      return_state=True)
                x = x + out
                sts.append(st)
                css.append(cs)
            new["mlstm"].append(tuple(torch.stack(t) for t in zip(*sts)))
            new["mconv"].append(torch.stack(css))
        else:
            sts, css = caches["mlstm"][r], caches["mconv"][r]
            for i, p_l in enumerate(seg):
                out, st, cs = xlstm_mod.mlstm_decode(
                    p_l, x, cfg, tuple(t[i] for t in sts), css[i])
                x = x + out
                for t, t_new in zip(sts, st):
                    t[i].copy_(t_new)
                css[i].copy_(cs)
            new["mlstm"].append(sts)
            new["mconv"].append(css)
        if n_s:
            if mode == "train":
                x = x + xlstm_mod.slstm_scan(slayers[r], x, cfg)
                continue
            state = caches["slstm"][r] if mode == "decode" else None
            out, st = xlstm_mod.slstm_scan(slayers[r], x, cfg, state=state,
                                           return_state=True)
            x = x + out
            new["slstm"].append(st)
    return x, (None if mode == "train" else new)


# ---------------------------------------------------------------------------
def _whisper_forward(p, cfg, tokens, enc_frames, mode, caches, pos):
    """Encoder-decoder.  ``enc_frames``: (B, S_enc, d) precomputed frame
    embeddings (the conv front end's stub), encoded in train and prefill;
    decode reads the encoder output from ``caches["enc_out"]``.  Every
    decoder layer projects its cross-attention K/V from the encoder
    output in every mode, decode included, as the reference does.  In
    decode the self-attention caches are written in place."""
    cd = _cdtype(cfg)
    dev = tokens.device

    def enc_layer(h, p_l):
        a = attn_mod.attention_train(
            p_l["attn"], norm(p_l["ln1"], h, cfg.norm, cfg.norm_eps), cfg,
            None, causal=False)
        h = h + a
        return h + ffn(p_l["ffn"], norm(p_l["ln2"], h, cfg.norm,
                                        cfg.norm_eps), cfg.act)

    if mode == "decode":
        enc_out = caches["enc_out"]
    else:
        x = enc_frames.to(cd) + sinusoidal_positions(
            enc_frames.shape[1], cfg.d_model, device=dev).to(cd)[None]
        f = _remat(enc_layer, cfg) if mode == "train" else enc_layer
        for p_l in _unstack(p["enc_blocks"]):
            x = f(x, p_l)
        enc_out = norm(p["enc_norm"], x, cfg.norm, cfg.norm_eps)

    x = embed(p["embed"], tokens,
              scale=cfg.d_model ** 0.5 if cfg.embed_scale else None).to(cd)
    if mode == "decode":
        x = x + sinusoidal_position_at(pos, cfg.d_model,
                                       device=dev).to(cd)[None, None, :]
    else:
        x = x + sinusoidal_positions(tokens.shape[1], cfg.d_model,
                                     device=dev).to(cd)[None]

    def dec_layer(h, p_l, cache=None):
        hh = norm(p_l["ln1"], h, cfg.norm, cfg.norm_eps)
        if mode == "train":
            a, new_self = attn_mod.attention_train(
                p_l["attn"], hh, cfg, None, causal=True), None
        elif mode == "prefill":
            a, new_self = attn_mod.attention_prefill(p_l["attn"], hh, cfg,
                                                     None, causal=True)
        else:
            a, new_self = attn_mod.attention_decode(p_l["attn"], hh, cfg,
                                                    cache, pos)
        h = h + a
        hh = norm(p_l["ln_x"], h, cfg.norm, cfg.norm_eps)
        # cross-attention against the encoder output
        k = attn_mod._split_heads(linear(p_l["xattn"]["wk"], enc_out),
                                  cfg.n_kv_heads, cfg.head_dim)
        v = attn_mod._split_heads(linear(p_l["xattn"]["wv"], enc_out),
                                  cfg.n_kv_heads, cfg.head_dim)
        if mode == "decode":
            xa, _ = attn_mod.attention_decode(p_l["xattn"], hh, cfg, None,
                                              pos, kv_override=(k, v))
        else:
            xa = attn_mod.attention_train(p_l["xattn"], hh, cfg, None,
                                          causal=False, kv_override=(k, v))
        h = h + xa
        hh = norm(p_l["ln2"], h, cfg.norm, cfg.norm_eps)
        return h + ffn(p_l["ffn"], hh, cfg.act), new_self

    layers = _unstack(p["dec_blocks"])
    if mode == "train":
        f = _remat(lambda h, p_l: dec_layer(h, p_l)[0], cfg)
        for p_l in layers:
            x = f(x, p_l)
        new_caches = None
    elif mode == "prefill":
        ks, vs = [], []
        for p_l in layers:
            x, c = dec_layer(x, p_l)
            ks.append(c["k"])
            vs.append(c["v"])
        new_caches = {"self": {"k": torch.stack(ks), "v": torch.stack(vs)},
                      "enc_out": enc_out}
    else:
        self_c = caches["self"]
        for i, p_l in enumerate(layers):
            x, _ = dec_layer(x, p_l, {"k": self_c["k"][i],
                                      "v": self_c["v"][i]})
        new_caches = {"self": self_c, "enc_out": enc_out}
    return norm(p["final_norm"], x, cfg.norm, cfg.norm_eps), new_caches
