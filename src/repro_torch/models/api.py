"""Public model API: init / loss / prefill / decode over a ``Decoder``
(the JAX package's ``models/api.py``).

Each function takes the parameters either as the ``Decoder`` itself,
whose f32 masters it casts for compute on every call as the reference
does at every forward, or as the tree :func:`prepare` made once, which
``launch.serve.generate`` hands to every step so the cast is not
repeated per token.  :func:`loss_fn` casts inside the autograd graph,
so the f32 masters receive the gradients (``launch.train``).

Under a mesh (``repro_torch.dist``) the parameters may also be a tree of
placed f32 masters (``dist.device_put`` by ``dist.sharding``'s rules):
:func:`prepare` gathers them for compute, and the gathered bytes count
in ``dist.gather.copied_bytes``; in training the gradients flow back to
every device's chunk.  The caches that :func:`prefill_step` and
:func:`init_cache` return under a mesh are placed by
``cache_shardings`` (batch over the data axes, sequence over
``model``), :func:`pad_caches` grows them stripe by stripe, and decode
writes them in place, never gathered.
"""
from __future__ import annotations

import torch

from .. import dist, obs
from ..dist import sharding as dist_sharding
from . import transformer
from .layers import cross_entropy_loss, logits_out

__all__ = ["init_params", "count_params", "prepare", "loss_fn",
           "forward_logits", "prefill_step", "decode_step", "init_cache",
           "transformer_cache_tree", "pad_caches", "place_caches"]


def init_params(generator: torch.Generator, cfg, *, device="cuda"):
    """A ``transformer.Decoder`` on ``device`` with weights drawn from
    ``generator`` (on the same kind of device) in the reference's
    distribution."""
    return transformer.init_decoder(generator, cfg, device=device)


def count_params(params) -> int:
    return sum(p.numel() for p in params.parameters())


# the stacked attention segments, cast as the reference's ``_prep_stack``
# casts them
STACKS = ("blocks", "dense_blocks", "moe_blocks")
# the hybrid, ssm and audio families' subtrees: the reference casts none
# of them ahead; each op casts what it uses to the compute dtype
CAST_AT_USE = ("mamba", "shared_in", "shared_attn", "mlstm", "slstm",
               "enc_blocks", "enc_norm", "dec_blocks")
# the leaves those ops cast: linear weights and biases, the convs, the
# mLSTM head projections and skip.  The rest (A_log, dt_bias, D, norm
# scales and biases, sLSTM's recurrence r) are read in f32.
_CAST_LEAVES = ("w", "b", "conv_w", "conv_b", "wq", "wk", "wv", "skip")


# the stacked experts ``_prep_stack`` pins to the EP layout under a mesh,
# in the order it visits them (dict keys sorted)
_EXPERTS = ("down", "gate", "up")


def _cast_at_use(t, cd):
    return {k: _cast_at_use(v, cd) if isinstance(v, dict)
            else (v.to(cd) if k in _CAST_LEAVES else v)
            for k, v in t.items()}


def prepare(params, cfg) -> dict:
    """The parameter tree cast once for compute, each leaf as the
    reference's ops cast it on every forward.  The stacked attention
    segments (``blocks``, ``dense_blocks``, ``moe_blocks``) as
    ``_prep_stack`` casts them: every leaf of rank >= 2 (weights, the
    router and the experts, and the per-layer norm scales and biases,
    rank 2 once stacked) to ``cfg.compute_dtype``.  The hybrid, ``ssm``
    and ``audio`` subtrees (``mamba``, ``shared_in``, ``shared_attn``,
    ``mlstm``, ``slstm``; ``enc_blocks``, ``enc_norm``, ``dec_blocks``),
    which the reference never passes through ``_prep_stack``: only the
    leaves its ops cast where they use them (``_CAST_LEAVES``);
    ``A_log``, ``dt_bias``, ``D``, the norms' scales and biases and
    sLSTM's ``r`` stay the f32 masters.  The output projection
    (``lm_head``, or the tied embedding table transposed) as
    ``logits_out`` casts it.  The embedding table and the final norm
    stay f32.  A no-op copy-free tree in f32 compute.

    ``params`` is a ``Decoder``, a tree of placed masters (every leaf a
    ``dist.Placed``: each gathered, the bytes counted) or a tree this
    function made (returned as it is).  Under a mesh, as the reference's
    ``_prep_stack`` pins them, the stacked experts of ``moe_blocks``
    (``gate``, ``up``, ``down``, (L, E, ...)) are then placed by
    ``P(None, model, None, None)`` (``model`` only where it divides E):
    each device holds its own experts for ``moe_ffn_ep``.

    The casts run in the span ``model/prepare`` (``obs.span``); a tree
    this function made returns at once, outside it."""
    if isinstance(params, dict):
        leaves = transformer.tree_leaves(params)
        if not all(isinstance(t, dist.Placed) for t in leaves):
            return params
    with obs.span("model/prepare"):
        return _prepare(params, cfg)


def _prepare(params, cfg) -> dict:
    if isinstance(params, dict):
        params = transformer.tree_map(dist.gather, params)
    cd = transformer._cdtype(cfg)
    p = transformer.tree(params) if not isinstance(params, dict) \
        else params
    for name in STACKS:
        if name in p:
            p[name] = transformer.tree_map(
                lambda a: a.to(cd) if a.ndim >= 2 and a.is_floating_point()
                else a, p[name])
    for name in CAST_AT_USE:
        if name in p:
            p[name] = _cast_at_use(p[name], cd)
    head = p["embed"]["table"].T if cfg.tie_embeddings else p["lm_head"]["w"]
    p["lm_head"] = {"w": head.to(cd)}
    ctx = dist.current()
    if ctx is not None and "moe" in p.get("moe_blocks", {}):
        experts = p["moe_blocks"]["moe"]
        for name in _EXPERTS:
            e = experts[name].shape[1]
            m = ctx.model_axis \
                if e % ctx.axis_size(ctx.model_axis) == 0 else None
            experts[name] = dist.place(experts[name], (None, m, None, None))
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
    """batch: {"tokens": (B, S) int, "loss_mask": (B, S) opt,
    "vision_embeds": (B, nv, d) opt, the VLM family's stub,
    "enc_frames": (B, S_enc, d), the audio family's}.  Next-token
    CE (a 0-dim f32 tensor) through the chunked loss: the label of the
    last position is 0 and masked out, ``loss_mask`` multiplies the mask,
    and the first ``cfg.vision_seq`` positions (a vision stub's) carry
    no label.  Differentiate it with ``loss.backward()`` after
    ``params.requires_grad_(True)``."""
    tokens = dist.gather(batch["tokens"])
    p = prepare(params, cfg)
    hidden, _ = transformer.forward(
        p, cfg, tokens, vision_embeds=dist.gather(batch.get("vision_embeds")),
        enc_frames=dist.gather(batch.get("enc_frames")), mode="train")
    labels = torch.cat([tokens[:, 1:], torch.zeros_like(tokens[:, :1])], 1)
    mask = torch.cat([torch.ones_like(tokens[:, 1:], dtype=torch.float32),
                      torch.zeros_like(tokens[:, :1], dtype=torch.float32)],
                     1)
    if batch.get("loss_mask") is not None:
        mask = mask * dist.gather(batch["loss_mask"]).float()
    if cfg.vision_seq:
        vis = torch.arange(tokens.shape[1], device=tokens.device) < \
            cfg.vision_seq
        mask = mask * (~vis[None, :]).float()
    return cross_entropy_loss(_logits_fn(p, cfg), hidden, labels, mask)


def forward_logits(params, cfg, batch):
    """Full-sequence logits (small configs / tests only)."""
    p = prepare(params, cfg)
    hidden, _ = transformer.forward(
        p, cfg, batch["tokens"], vision_embeds=batch.get("vision_embeds"),
        enc_frames=batch.get("enc_frames"), mode="train")
    return _logits_fn(p, cfg)(hidden)


def prefill_step(params, cfg, batch):
    """Run the prompt; return (last-token logits, caches), the caches
    placed by ``cache_shardings`` under a mesh (:func:`place_caches`)."""
    p = prepare(params, cfg)
    hidden, caches = transformer.forward(
        p, cfg, batch["tokens"], vision_embeds=batch.get("vision_embeds"),
        enc_frames=batch.get("enc_frames"), mode="prefill")
    return _logits_fn(p, cfg)(hidden[:, -1:]), place_caches(cfg, caches)


def decode_step(params, cfg, token, caches, pos):
    """One decode step.  token: (B, 1) int; pos: int (the index this
    token occupies; the KV cache holds ``pos`` valid entries).  The
    caches (placed or not) are updated in place and returned."""
    p = prepare(params, cfg)
    hidden, caches = transformer.forward(p, cfg, token, mode="decode",
                                         caches=caches, pos=int(pos))
    return _logits_fn(p, cfg)(hidden), caches


# ---------------------------------------------------------------------------
def init_cache(cfg, batch: int, seq_len: int, dtype=None, *, device="cuda"):
    """:func:`_zeroed_caches`, placed under a mesh (:func:`place_caches`;
    not on ``meta``)."""
    out = _zeroed_caches(cfg, batch, seq_len, dtype, device=device)
    return out if torch.device(device).type == "meta" else \
        place_caches(cfg, out)


def _zeroed_caches(cfg, batch: int, seq_len: int, dtype=None, *,
                  device="cuda"):
    """Zeroed caches of the decode shape (filled by prefill in real
    serving): for the dense and VLM families {"k", "v"} of (n_layers, B,
    n_kv_heads, S, head_dim); for the MoE family one such tree per
    segment, {"dense", "moe"} ({"moe"} alone with no leading dense
    layer), each {"c_kv": (n, B, S, kv_lora_rank), "k_rope": (n, B, S,
    rope_head_dim)} under MLA.  For the hybrid family one entry per
    Mamba segment in the lists ``mamba`` (f32 states (nl, B, H, N, dh))
    and ``conv`` ((nl, B, K-1, d_in + 2N) in the compute dtype), and in
    ``attn`` one {"k", "v"} of (B, n_kv_heads, S, head_dim) per shared
    block call site.  For the ``ssm`` family per repeat ``mlstm`` (C, n,
    m) f32 tuples stacked over its layers, ``mconv`` conv states in the
    compute dtype and ``slstm`` (c, n, m, h) f32 tuples (m at -1e30).
    For the ``audio`` family ``self``, {"k", "v"} of (n_layers, B,
    n_kv_heads, S, head_dim), and ``enc_out`` (B, encoder_seq,
    d_model).  ``device="meta"`` gives the shapes and dtypes alone."""
    transformer.require_ported(cfg)
    dt = dtype or transformer._cdtype(cfg)
    b, s = batch, seq_len

    def zeros(*shape, dtype=dt):
        return torch.zeros(shape, dtype=dtype, device=device)

    def neg(*shape):
        return torch.full(shape, -1e30, dtype=torch.float32, device=device)

    def attn_cache(*lead):
        shape = lead + (b, cfg.n_kv_heads, s, cfg.head_dim)
        return {"k": zeros(*shape), "v": zeros(*shape)}

    def mla_cache(n):
        return {"c_kv": zeros(n, b, s, cfg.kv_lora_rank),
                "k_rope": zeros(n, b, s, cfg.rope_head_dim)}

    f32 = torch.float32
    if cfg.family in ("dense", "vlm"):
        return transformer_cache_tree(attn_cache(cfg.n_layers))
    if cfg.family == "hybrid":
        bounds = [0] + transformer._zamba_attn_positions(cfg) + \
            [cfg.n_layers]
        d_in, n_ssm, h = cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_heads
        out = {"mamba": [], "conv": [], "attn": []}
        for si in range(len(bounds) - 1):
            nl = bounds[si + 1] - bounds[si]
            out["mamba"].append(zeros(nl, b, h, n_ssm, d_in // h,
                                      dtype=f32))
            out["conv"].append(zeros(nl, b, cfg.ssm_d_conv - 1,
                                     d_in + 2 * n_ssm))
            if si > 0:
                out["attn"].append(attn_cache())
        return out
    if cfg.family == "ssm":
        n_s = transformer._xlstm_slstm_count(cfg)
        per = (cfg.slstm_every - 1) if n_s else cfg.n_layers
        n_m = cfg.n_layers - n_s
        h, d_in = cfg.n_heads, cfg.xlstm_d_inner
        dh, dmh = d_in // h, cfg.d_model // h
        out = {"mlstm": [], "mconv": [], "slstm": []}
        for r in range(n_s if n_s else 1):
            nl = min((r + 1) * per, n_m) - r * per
            out["mlstm"].append((zeros(nl, b, h, dh, dh, dtype=f32),
                                 zeros(nl, b, h, dh, dtype=f32),
                                 neg(nl, b, h)))
            out["mconv"].append(zeros(nl, b, cfg.xlstm_d_conv - 1, d_in))
            if n_s:
                out["slstm"].append((zeros(b, h, dmh, dtype=f32),
                                     zeros(b, h, dmh, dtype=f32),
                                     neg(b, h, dmh),
                                     zeros(b, h, dmh, dtype=f32)))
        return out
    if cfg.family == "audio":
        return {"self": attn_cache(cfg.n_layers),
                "enc_out": zeros(b, cfg.encoder_seq, cfg.d_model)}
    seg_cache = mla_cache if cfg.mla else attn_cache
    out = {"moe": seg_cache(cfg.n_layers - cfg.first_dense)}
    if cfg.first_dense:
        out["dense"] = seg_cache(cfg.first_dense)
    return out


def transformer_cache_tree(c):
    return c


def place_caches(cfg, caches):
    """Under a mesh, the sequence-indexed cache leaves (k/v/c_kv/k_rope)
    placed by ``dist.sharding.cache_shardings``; the recurrent states and
    the encoder output stay as they are.  With no mesh, ``caches``."""
    ctx = dist.current()
    if ctx is None:
        return caches

    def one(path, leaf):
        name = dist_sharding._cache_key(path)
        if name not in dist_sharding._SEQ_CACHE_KEYS or \
                isinstance(leaf, dist.Placed):
            return leaf
        sh = dist_sharding.cache_shardings(cfg, {name: leaf}, ctx)[name]
        return dist.device_put(leaf, sh)
    return dist_sharding._map_with_path(one, caches)


def pad_caches(caches, target_len: int):
    """Grow every sequence-indexed cache leaf (k/v/c_kv/k_rope, seq axis
    -2) to ``target_len`` with zeros so decode can continue past the
    prompt length.  Lists and tuples are walked too, a leaf named by the
    nearest dict key above it (the hybrid family's ``attn`` list of
    {"k", "v"}), as ``tree_map_with_path`` walks them in the reference;
    every other leaf is returned as it is.  A placed leaf grows stripe by
    stripe (``dist.reshard``): its sequence stays striped over the same
    axes where they divide ``target_len``, and no full cache is made.
    Recorded as the span ``serve/pad_caches``."""
    def visit(path, leaf):
        if dist_sharding._cache_key(path) not in \
                dist_sharding._SEQ_CACHE_KEYS or leaf.shape[-2] >= target_len:
            return leaf
        shape = tuple(leaf.shape[:-2]) + (target_len, leaf.shape[-1])
        if isinstance(leaf, dist.Placed):
            return dist.reshard(leaf, _grown(leaf.sharding, shape), shape)
        pad = leaf.new_zeros(shape[:-2] + (target_len - leaf.shape[-2],
                                           leaf.shape[-1]))
        return torch.cat([leaf, pad], dim=-2)
    with obs.span("serve/pad_caches"):
        return dist_sharding._map_with_path(visit, caches)


def _grown(sh, shape):
    """``sh``'s spec on a cache grown to ``shape``: the sequence axis (-2)
    keeps its mesh axes where they divide the new length."""
    spec = list(sh.spec) + [None] * (len(shape) - len(sh.spec))
    axes = spec[-2]
    if axes is not None:
        names = (axes,) if isinstance(axes, str) else axes
        n = 1
        for a in names:
            n *= sh.mesh.shape[a]
        if shape[-2] % n:
            spec[-2] = None
    return dist.NamedSharding(sh.mesh, dist.PartitionSpec(*spec))
