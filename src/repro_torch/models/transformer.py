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

Under a mesh, ``dist.constrain_seq`` runs where the reference calls it:
on the embeddings and after every block in train and prefill (the
attention stacks, the Zamba2 and mLSTM stacks in training, whisper's
encoder and its decoder in training).  It records the spec it imposes
and leaves the value as it is.

On ``meta`` tensors (a dry run, ``launch.dryrun``) every loop over the
layers, the Zamba2 segments and the xLSTM repeats runs its first, second
and last items, the second counted for the rest (``metatrace.steps``);
the caches of the items not run are views of the second's.
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

from .. import dist, metatrace, obs
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
    dist.constrain_seq(x)
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
        # the recompute runs in the backward pass, on the autograd
        # engine's thread for CUDA tensors: it reinstalls the ambient mesh
        ctx = dist.current()

        def under_mesh(*a):
            with dist.use_context(ctx):
                return f(*a)
        return checkpoint(metatrace.frozen(under_mesh), *args,
                          use_reentrant=False, context_fn=context_fn)
    return g


class _Layers:
    """The layers of a stacked parameter tree: ``[i]`` is layer ``i``'s
    tree, ``[a:b]`` the layers a..b-1.  A tensor leaf is viewed by one
    ``unbind`` (the backward pass stacks the layers' gradients once); a
    placed leaf (the EP-pinned experts) is indexed when its layer is
    read, so a loop that reads only some layers (a ``meta`` trace) makes
    only their views."""

    def __init__(self, cols, start: int, stop: int):
        self.cols, self.start, self.stop = cols, start, stop

    def __len__(self) -> int:
        return self.stop - self.start

    def __iter__(self):
        return (self[i] for i in range(len(self)))

    def __getitem__(self, i):
        if isinstance(i, slice):
            a, b, step = i.indices(len(self))
            if step != 1:
                raise IndexError("layers slice with step 1 only")
            return _Layers(self.cols, self.start + a, self.start + b)
        if not -len(self) <= i < len(self):
            raise IndexError(i)
        j = self.start + (i % len(self))
        return tree_map(lambda c: c[j], self.cols)


def _unstack(stacked) -> _Layers:
    """One parameter tree per layer, views of the stacked leaves."""
    cols = tree_map(lambda a: a if isinstance(a, dist.Placed)
                    else a.unbind(0), stacked)
    leaf = tree_leaves(cols)[0]
    n = leaf.shape[0] if isinstance(leaf, dist.Placed) else len(leaf)
    return _Layers(cols, 0, n)


def _run_attn_stack(stacked, x, cfg, positions, mode, caches, pos, *,
                    moe_layer: bool):
    layers = _unstack(stacked)
    if mode == "train":
        def body(h, p_l):
            # a span of its own, also in a checkpoint's recompute, so that
            # the recompute's work outside attention and the MoE FFN is
            # told apart from the backward span it runs inside
            with obs.span("model/block"):
                out = block_apply(p_l, h, cfg, positions,
                                  moe_layer=moe_layer, mode="train")[0]
            dist.constrain_seq(out)
            return out
        f = _remat(body, cfg)
        for p_l in metatrace.steps(layers, like=x):
            x = f(x, p_l)
        return x, None
    loop = metatrace.steps(range(len(layers)), like=x)
    if mode == "prefill":
        # whatever cache leaves the block returns (k/v, or c_kv/k_rope),
        # stacked over the layers
        collected: dict[str, list] = {}
        for i in loop:
            x, c = block_apply(layers[i], x, cfg, positions,
                               moe_layer=moe_layer, mode="prefill")
            dist.constrain_seq(x)
            for name, leaf in c.items():
                collected.setdefault(name, []).append(leaf)
        return x, {name: torch.stack(loop.fill(leaves))
                   for name, leaves in collected.items()}
    for i in loop:
        p_l = layers[i]
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
        out = mamba_mod.mamba_chunked(p_l, h, cfg)
        dist.constrain_seq(out)
        return out
    mamba_train = _remat(mamba_train, cfg)

    # segments 1 .. n-2 are alike (the shared block, attn_every layers)
    segs = metatrace.steps(range(len(bounds) - 1), like=x)
    for si in segs:
        if si > 0:
            h = linear(p["shared_in"], torch.cat([x, x0], -1))
            x, c = block_apply(p["shared_attn"], h, cfg, positions,
                               mode=mode, pos=pos,
                               cache=caches["attn"][si - 1]
                               if mode == "decode" else None)
            new["attn"].append(c)
        seg = layers[bounds[si]:bounds[si + 1]]
        loop = metatrace.steps(range(len(seg)), like=x)
        if mode == "train":
            for p_l in metatrace.steps(seg, like=x):
                x = mamba_train(x, p_l)
        elif mode == "prefill":
            sts, css = [], []
            for i in loop:
                x, st, cs = mamba_mod.mamba_chunked(seg[i], x, cfg,
                                                    return_state=True)
                sts.append(st)
                css.append(cs)
            new["mamba"].append(torch.stack(loop.fill(sts)))
            new["conv"].append(torch.stack(loop.fill(css)))
        else:
            sts, css = caches["mamba"][si], caches["conv"][si]
            for i in loop:
                x, st, cs = mamba_mod.mamba_decode(seg[i], x, cfg, sts[i],
                                                   css[i])
                sts[i].copy_(st)
                css[i].copy_(cs)
    if mode == "train":
        return x, None
    if mode == "decode":
        # written in place: the caches are the ones given
        return x, {k: caches[k] for k in new}
    return x, {k: segs.fill(v) for k, v in new.items()}


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
        out = h + xlstm_mod.mlstm_chunked(p_l, h, cfg)
        dist.constrain_seq(out)
        return out
    mlstm_train = _remat(mlstm_train, cfg)

    # the repeats are alike (per mLSTM layers, then one sLSTM)
    reps = metatrace.steps(list(enumerate(slayers)) if n_s else [(0, None)],
                           like=x)
    for r, s_l in reps:
        seg = mlayers[r * per:min((r + 1) * per, n_m)]
        loop = metatrace.steps(range(len(seg)), like=x)
        if mode == "train":
            for p_l in metatrace.steps(seg, like=x):
                x = mlstm_train(x, p_l)
        elif mode == "prefill":
            sts, css = [], []
            for i in loop:
                out, st, cs = xlstm_mod.mlstm_chunked(seg[i], x, cfg,
                                                      return_state=True)
                x = x + out
                sts.append(st)
                css.append(cs)
            new["mlstm"].append(tuple(torch.stack(t)
                                      for t in zip(*loop.fill(sts))))
            new["mconv"].append(torch.stack(loop.fill(css)))
        else:
            sts, css = caches["mlstm"][r], caches["mconv"][r]
            for i in loop:
                out, st, cs = xlstm_mod.mlstm_decode(
                    seg[i], x, cfg, tuple(t[i] for t in sts), css[i])
                x = x + out
                for t, t_new in zip(sts, st):
                    t[i].copy_(t_new)
                css[i].copy_(cs)
        if n_s:
            if mode == "train":
                x = x + xlstm_mod.slstm_scan(s_l, x, cfg)
                continue
            state = caches["slstm"][r] if mode == "decode" else None
            out, st = xlstm_mod.slstm_scan(s_l, x, cfg, state=state,
                                           return_state=True)
            x = x + out
            new["slstm"].append(st)
    if mode == "train":
        return x, None
    if mode == "decode":
        # the mLSTM states are written in place, the sLSTM's are new
        return x, {"mlstm": caches["mlstm"], "mconv": caches["mconv"],
                   "slstm": reps.fill(new["slstm"])}
    return x, {k: reps.fill(v) for k, v in new.items()}


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
        out = h + ffn(p_l["ffn"], norm(p_l["ln2"], h, cfg.norm,
                                       cfg.norm_eps), cfg.act)
        dist.constrain_seq(out)
        return out

    if mode == "decode":
        enc_out = caches["enc_out"]
    else:
        x = enc_frames.to(cd) + sinusoidal_positions(
            enc_frames.shape[1], cfg.d_model, device=dev).to(cd)[None]
        f = _remat(enc_layer, cfg) if mode == "train" else enc_layer
        for p_l in metatrace.steps(_unstack(p["enc_blocks"]), like=x):
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
    loop = metatrace.steps(range(len(layers)), like=x)
    if mode == "train":
        def dec_train(h, p_l):
            out = dec_layer(h, p_l)[0]
            dist.constrain_seq(out)
            return out
        f = _remat(dec_train, cfg)
        for p_l in metatrace.steps(layers, like=x):
            x = f(x, p_l)
        new_caches = None
    elif mode == "prefill":
        ks, vs = [], []
        for i in loop:
            x, c = dec_layer(x, layers[i])
            ks.append(c["k"])
            vs.append(c["v"])
        new_caches = {"self": {"k": torch.stack(loop.fill(ks)),
                               "v": torch.stack(loop.fill(vs))},
                      "enc_out": enc_out}
    else:
        self_c = caches["self"]
        for i in loop:
            x, _ = dec_layer(x, layers[i], {"k": self_c["k"][i],
                                            "v": self_c["v"][i]})
        new_caches = {"self": self_c, "enc_out": enc_out}
    return norm(p["final_norm"], x, cfg.norm, cfg.norm_eps), new_caches
