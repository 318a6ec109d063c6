"""GQA attention: training/prefill (through ``kernels.flash_attention``)
and decode (KV cache), the JAX package's ``models/attention.py``.

Decode computes attention with plain einsums over the KV cache, as the
reference does.  ``kv_override`` hands in K/V already in head layout, the
encoder-decoder family's cross-attention over the encoder output.

Under a mesh (``repro_torch.dist``) the reference's hooks run where it
calls them: ``dist.constrain_heads`` on q, k, v and the output, and the
attention itself runs once per mesh position, on the (batch, head) chunk
that q's spec gives the position (:func:`attend`): that is where the
flash kernel launches.  Decode under a mesh is the reference's
sequence-parallel :func:`_decode_sp` over the KV cache striped along the
``model`` axis: each stripe is written in place on the device that holds
it, each device attends over its own stripe, and the partials merge by
the exact log-sum-exp combine (:func:`combine_stripes`), an exchange of
(max, sum, output) between the positions of each ``model`` group whose
bytes are counted.  The cache is never gathered.

On ``meta`` tensors (a dry run, ``launch.dryrun``) the loops over mesh
positions and ``model`` groups run three of their items, the middle one
counted for the rest (``metatrace.steps``): every position's chunk has
one shape.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
from torch import nn

from .. import dist, metatrace
from ..kernels.flash_attention import ops as fa_ops
from . import rope as rope_mod
from .layers import Linear, draw, joined, linear, pieces

_NEG_INF = -1e30


class Attention(nn.Module):
    """``init_attention``: wq, wk, wv (with bias for ``qkv_bias``), wo."""

    def __init__(self, cfg, *, layers: int | None = None, device=None):
        super().__init__()
        d, hq, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, \
            cfg.head_dim
        kw = dict(layers=layers, device=device)
        self.wq = Linear(d, hq * dh, bias=cfg.qkv_bias, **kw)
        self.wk = Linear(d, hkv * dh, bias=cfg.qkv_bias, **kw)
        self.wv = Linear(d, hkv * dh, bias=cfg.qkv_bias, **kw)
        self.wo = Linear(hq * dh, d, **kw)


def init_attention(generator, cfg, *, layers: int | None = None,
                   device=None) -> Attention:
    return draw(Attention(cfg, layers=layers, device=device), generator)


def _split_heads(x, n_heads, d_head):
    b, s, _ = x.shape
    return x.reshape(b, s, n_heads, d_head).transpose(1, 2)


def _merge_heads(x):
    b, h, s, d = x.shape
    return x.transpose(1, 2).reshape(b, s, h * d)


def _position_encode(q, k, cfg, positions):
    if cfg.rope_type == "rope":
        q = rope_mod.apply_rope(q, positions, theta=cfg.rope_theta)
        k = rope_mod.apply_rope(k, positions, theta=cfg.rope_theta)
    elif cfg.rope_type == "mrope":
        pos3 = positions[None].expand((3,) + tuple(positions.shape))
        q = rope_mod.apply_mrope(q, pos3, cfg.mrope_sections,
                                 theta=cfg.rope_theta)
        k = rope_mod.apply_mrope(k, pos3, cfg.mrope_sections,
                                 theta=cfg.rope_theta)
    return q, k


def _qkv(p, x, cfg, positions):
    q = _split_heads(linear(p["wq"], x), cfg.n_heads, cfg.head_dim)
    spec = dist.constrain_heads(q)
    k = _split_heads(linear(p["wk"], x), cfg.n_kv_heads, cfg.head_dim)
    v = _split_heads(linear(p["wv"], x), cfg.n_kv_heads, cfg.head_dim)
    q, k = _position_encode(q, k, cfg, positions)
    dist.constrain_heads(k)
    dist.constrain_heads(v)
    # the flash kernel takes contiguous (B, H, S, D) operands
    return q.contiguous(), k.contiguous(), v.contiguous(), spec


def attend(q, k, v, spec, *, causal: bool, impl: str, q_chunk: int,
           k_chunk: int, scale: float | None = None):
    """``fa_ops.attention`` over q (B, Hq, Sq, D) and k, v (B, Hkv, Skv,
    D*): one call with no spec (no mesh, or no axis divides); under the
    ambient mesh one call per mesh position on the (batch, head) chunk of
    q that ``spec`` (``dist.constrain_heads``' of q) gives it, with the KV
    heads its query heads read, each chunk made contiguous on the
    position's device for the kernel.  Where a chunk's query heads do not
    cover whole groups of G, each query head gets its own KV head (group
    1 in the call), taken by one index for all chunks before the loops.
    The output (B, Hq, Sq, Dv) is assembled on q's device.

    Each operand is split once, before the loops, into the distinct
    chunks (along batch, then along heads), and the output is the
    chunks' results concatenated: the backward pass gathers each
    operand's gradient in one ``cat``, as the reference's partitioned
    program writes each device's shard.  Positions that hold the same
    chunk (a replicated axis) read that chunk's pieces; the first one's
    result is the chunk's, the others' backward passes run on a zero
    gradient, as each replica computes its own."""
    kw = dict(causal=causal, scale=scale, impl=impl, q_chunk=q_chunk,
              k_chunk=k_chunk)
    if spec is None:
        return fa_ops.attention(q, k, v, **kw)
    index = dist.NamedSharding(dist.current().mesh, spec) \
        .devices_indices_map(tuple(q.shape))
    b, hq = q.shape[:2]
    g = hq // k.shape[1]
    # the positions that hold each chunk, by (batch start, head start)
    holders: dict[tuple, list] = {}
    for dev, (bs, hs, _, _) in index.items():
        holders.setdefault((bs.indices(b)[0], hs.indices(hq)[0]), []) \
            .append(dev)
    b0s = sorted({c[0] for c in holders})
    h0s = sorted({c[1] for c in holders})
    nh = len(h0s)
    if (hq // nh) % g:
        # a chunk splits a group: every query head its own KV head
        kv = torch.arange(hq, device=k.device) // g
        k, v = (t.index_select(1, kv) for t in (k, v))
    rows = metatrace.steps(zip(b0s, *(pieces(t, len(b0s), 0)
                                      for t in (q, k, v))), like=q)
    out_rows = []
    for b0, qb, kb, vb in rows:
        cols = metatrace.steps(zip(h0s, *(pieces(t, nh, 1)
                                          for t in (qb, kb, vb))), like=q)
        outs = []
        for h0, qc, kc, vc in cols:
            outs.append(_on_holders(holders[b0, h0], qc, kc, vc, kw,
                                    q.device))
        out_rows.append(joined(cols.fill(outs), 1))
    return joined(rows.fill(out_rows), 0)


def _on_holders(devs, qc, kc, vc, kw, home):
    """The chunk's attention on each device that holds it (its operands
    made contiguous there), returned on ``home``: the first device's
    result, the others' each reached by a zero gradient.  A replica's
    result is dropped as soon as it is taken, so that every replica
    leaves alive only what its backward pass saves."""
    def run(dev):
        on = dev.torch_device
        return fa_ops.attention(*(t.to(on).contiguous()
                                  for t in (qc, kc, vc)), **kw).to(home)
    loop = iter(metatrace.steps(devs, like=qc))
    out = run(next(loop))
    for dev in loop:
        out = _Replica.apply(out, run(dev))
    return out


class _Replica(torch.autograd.Function):
    """``kept``; the backward pass hands ``replica`` (an equal result) a
    zero gradient, made just before the replica's own backward runs."""

    @staticmethod
    def forward(ctx, kept, replica):
        return kept.view_as(kept)

    @staticmethod
    def backward(ctx, grad):
        return grad, torch.zeros_like(grad)


def _attend(q, k, v, spec, cfg, causal):
    return attend(q, k, v, spec, causal=causal, impl=cfg.attn_impl,
                  q_chunk=cfg.attn_q_chunk, k_chunk=cfg.attn_k_chunk)


def attention_train(p, x, cfg, positions, *, causal: bool = True,
                    kv_override=None):
    """Full-sequence attention.  ``kv_override``: (k, v) already in head
    layout (the whisper decoder's cross-attention); only q is projected,
    and position-encoded only under a rotary ``cfg.rope_type``."""
    if kv_override is None:
        return attention_prefill(p, x, cfg, positions, causal=causal)[0]
    q = _split_heads(linear(p["wq"], x), cfg.n_heads, cfg.head_dim)
    spec = dist.constrain_heads(q)
    if cfg.rope_type != "none":
        q, _ = _position_encode(q, q, cfg, positions)
    k, v = kv_override
    out = _attend(q.contiguous(), k.contiguous(), v.contiguous(), spec,
                  cfg, causal)
    dist.constrain_heads(out)
    return linear(p["wo"], _merge_heads(out))


def attention_prefill(p, x, cfg, positions, *, causal: bool = True):
    """Like train, but also returns the KV cache contents."""
    q, k, v, spec = _qkv(p, x, cfg, positions)
    out = _attend(q, k, v, spec, cfg, causal)
    dist.constrain_heads(out)
    return linear(p["wo"], _merge_heads(out)), {"k": k, "v": v}


# ---------------------------------------------------------------------------
# sequence-parallel decode over a striped cache
def stripes(leaf, spec):
    """``(index, chunks)`` of a cache leaf laid out by ``spec`` over the
    ambient mesh: each device's index and chunk.  A placed leaf gives its
    own chunks, and must be laid out so (no leaf is resharded here); a
    tensor gives views of itself."""
    sharding = dist.NamedSharding(dist.current().mesh, spec)
    index = sharding.devices_indices_map(tuple(leaf.shape))
    if not isinstance(leaf, dist.Placed):
        return index, {dev: leaf[idx] for dev, idx in index.items()}
    if not leaf.laid_out_as(sharding):
        raise ValueError(f"a cache placed as {leaf.sharding.spec} does not "
                         f"stripe as {spec}")
    return index, leaf.shards


def model_groups(ctx) -> np.ndarray:
    """One row per position of the other axes: its devices in
    ``model``-axis order."""
    m_dim = ctx.mesh.axis_names.index(ctx.model_axis)
    return np.moveaxis(ctx.mesh.devices, m_dim, -1) \
        .reshape(-1, ctx.axis_size(ctx.model_axis))


def combine_stripes(partials: dict, groups) -> dict:
    """The exact log-sum-exp merge of per-stripe partial attentions:
    ``partials[dev]`` is (max, sum, unnormalized output) over the
    device's stripe, with the max and sum keeping a trailing 1.  Every
    device of a group receives the others' partials (the counterpart of
    the reference's ``pmax``/``psum`` over the ``model`` axis; the bytes
    copied between devices count in ``combine_stripes.exchanged_bytes``)
    and returns the merged output: sum_j o_j w_j / sum_j l_j w_j, w_j =
    exp(m_j - max_j m_j).  A stripe whose every key is masked has m_j at
    -1e30 and contributes w_j = 0."""
    first = next(iter(partials.values()))
    for t in first:
        dist.record_exchange("all-reduce", t.numel() * t.element_size(),
                             len(groups[0]))
    out = {}
    for group in metatrace.steps(groups, like=first[0]):
        for dev in metatrace.steps(group, like=first[0]):
            parts = []
            for src in group:
                if src != dev:
                    combine_stripes.exchanged_bytes += sum(
                        t.numel() * t.element_size() for t in partials[src]
                    ) * metatrace.multiplier()
                parts.append([t.to(dev.torch_device, copy=src != dev)
                              for t in partials[src]])
            m_glob = functools.reduce(torch.maximum, [p[0] for p in parts])
            w = [torch.exp(p[0] - m_glob) for p in parts]
            denom = sum(p[1] * wi for p, wi in zip(parts, w))
            out[dev] = sum(p[2] * wi for p, wi in zip(parts, w)) / denom
    return metatrace.fill_keys(out, [d for g in groups for d in g])


combine_stripes.exchanged_bytes = 0


def decode_stripes(cache: dict, new: dict, spec, seq_dim: int, at: int,
                   pos: int, score, value, out):
    """The body of a sequence-parallel decode, once per device of the
    ambient mesh, over the cache leaves ``cache[name]`` laid out by
    ``spec`` with the sequence on ``seq_dim``.  The device whose stripe
    holds position ``at`` writes ``new[name]`` (one position) there in
    place; each device scores its own keys, ``score(bs, chunks, dev)``
    in f32 with the keys last, masks those after ``pos``, and forms its
    partial (max, sum, ``value(probs, chunks)``); the partials merge by
    :func:`combine_stripes`, and each device's merged output lands in
    ``out`` at its batch rows.  Returns ``out``."""
    index, chunks = None, {}
    for name, leaf in cache.items():
        idx, chunks[name] = stripes(leaf, spec)
        index = index or idx
    s_len = next(iter(cache.values())).shape[seq_dim]
    # the stripes that hold ``at`` (one per batch shard) take the new entry
    for dev, idx in index.items():
        start, stop, _ = idx[seq_dim].indices(s_len)
        if start <= at < stop:
            for name, c in chunks.items():
                c[dev].narrow(seq_dim, at - start, 1).copy_(
                    new[name][idx[0]])
    partials = {}
    for dev, idx in metatrace.steps(index.items(), like=out):
        bs, ss, on = idx[0], idx[seq_dim], dev.torch_device
        mine = {name: c[dev] for name, c in chunks.items()}
        start = ss.indices(s_len)[0]
        s_l = next(iter(mine.values())).shape[seq_dim]
        sc = score(bs, mine, dev)
        valid = start + torch.arange(s_l, device=on) <= pos
        sc = sc.masked_fill(~valid, _NEG_INF)
        mx = sc.amax(-1, keepdim=True)
        pr = torch.exp(sc - mx)
        partials[dev] = (mx, pr.sum(-1, keepdim=True), value(pr, mine))
    merged = combine_stripes(metatrace.fill_keys(partials, index),
                             model_groups(dist.current()))
    for dev, idx in metatrace.steps(index.items(), like=out):
        rows = out[idx[0]]
        out[idx[0]] = merged[dev].reshape(rows.shape).to(out.device,
                                                          out.dtype)
    return out


def _decode_sp(q, k_new, v_new, cache, pos: int, cfg, ctx):
    """Sequence-parallel decode over the ``model``-striped KV cache (the
    reference's ``_decode_sp``, its ``shard_map`` body run once per mesh
    position by :func:`decode_stripes`).  Each stripe updates *in place*
    on the device that holds it, and only when ``pos`` falls inside it
    (at ``pos`` >= S no stripe writes), then computes a partial attention
    over its keys (those at or before ``pos``); the partials combine
    exactly (:func:`combine_stripes`).  The batch splits over the data
    axes when they divide it.  This is the paper's memory-controller
    striping applied to the KV data plane, the small combine its only
    traffic."""
    b = q.shape[0]
    bspec = ctx.all_data_axes if b % ctx.dp_size() == 0 else None
    spec = dist.PartitionSpec(bspec, None, ctx.model_axis, None)
    scale = cfg.head_dim ** -0.5
    g = cfg.n_heads // cfg.n_kv_heads

    def score(bs, kv, dev):
        qg = q[bs, :, 0].to(dev.torch_device).reshape(
            -1, cfg.n_kv_heads, g, cfg.head_dim)
        return torch.einsum("bhgd,bhsd->bhgs", qg.float(),
                            kv["k"].float()) * scale

    def value(pr, kv):
        return torch.einsum("bhgs,bhsd->bhgd", pr, kv["v"].float())

    o = q.new_empty((b, cfg.n_heads, 1, cfg.head_dim))
    decode_stripes({"k": cache["k"], "v": cache["v"]},
                   {"k": k_new, "v": v_new}, spec, 2, pos, pos, score, value,
                   o)
    return o, cache


def attention_decode(p, x, cfg, cache, pos: int, *, kv_override=None):
    """One-token decode.  x: (B, 1, d); cache: {"k","v"} (B, Hkv, S, D);
    pos: the index of this token (the cache holds ``pos`` valid entries
    before the update).  The cache is written in place at ``pos``,
    clamped into range as ``dynamic_update_slice`` clamps its start, and
    returned.  With ``kv_override`` (k, v) in head layout no cache is
    written, every key is valid, and ``cache`` is returned as given.
    Under any mesh that is not ``model_in_batch`` and whose ``model``
    size divides S (``single_device_mesh()`` and a data-only mesh among
    them) the decode is :func:`_decode_sp`, as the reference gates it; a
    placed cache decodes there only."""
    b = x.shape[0]
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    q = _split_heads(linear(p["wq"], x), cfg.n_heads, cfg.head_dim)
    if kv_override is None:
        k_new = _split_heads(linear(p["wk"], x), cfg.n_kv_heads,
                             cfg.head_dim)
        v_new = _split_heads(linear(p["wv"], x), cfg.n_kv_heads,
                             cfg.head_dim)
        q, k_new = _position_encode(q, k_new, cfg, positions)
        ctx = dist.current()
        if (ctx is not None and not ctx.model_in_batch
                and cache["k"].shape[2] % ctx.axis_size(ctx.model_axis)
                == 0):
            o, cache = _decode_sp(q, k_new, v_new, cache, pos, cfg, ctx)
            return linear(p["wo"], _merge_heads(o)), cache
        k, v = cache["k"], cache["v"]
        if isinstance(k, dist.Placed):
            raise ValueError("a placed KV cache decodes through _decode_sp "
                             "only (a mesh that is not model_in_batch and "
                             "whose model size divides its length)")
        s_len = k.shape[2]
        at = min(max(pos, 0), s_len - 1)
        k[:, :, at:at + 1] = k_new.to(k.dtype)
        v[:, :, at:at + 1] = v_new.to(v.dtype)
        valid = torch.arange(s_len, device=x.device) <= pos      # (S,)
    else:
        if cfg.rope_type != "none":
            q, _ = _position_encode(q, q, cfg, positions)
        k, v = kv_override
        valid = torch.ones(k.shape[2], dtype=torch.bool, device=x.device)

    # GQA decode: (B, Hq, 1, D) x (B, Hkv, S, D)
    g = cfg.n_heads // cfg.n_kv_heads
    qg = q.reshape(b, cfg.n_kv_heads, g, cfg.head_dim)
    scale = cfg.head_dim ** -0.5
    s = torch.einsum("bhgd,bhsd->bhgs", qg.float(), k.float()) * scale
    s = s.masked_fill(~valid, _NEG_INF)
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgs,bhsd->bhgd", w, v.float())
    o = o.reshape(b, cfg.n_heads, 1, cfg.head_dim).to(x.dtype)
    return linear(p["wo"], _merge_heads(o)), cache
