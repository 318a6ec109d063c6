"""GQA attention: training/prefill (through ``kernels.flash_attention``)
and decode (KV cache), the JAX package's ``models/attention.py``.

Decode computes attention with plain einsums over the KV cache, as the
reference does; its sequence-parallel form (``_decode_sp``) comes with
the sharded mesh layer.  ``kv_override`` hands in K/V already in head
layout, the encoder-decoder family's cross-attention over the encoder
output.  The reference's ``dist`` sharding hooks are no-ops without a
mesh and have no counterpart.
"""
from __future__ import annotations

import torch
from torch import nn

from ..kernels.flash_attention import ops as fa_ops
from . import rope as rope_mod
from .layers import Linear, draw, linear

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
    k = _split_heads(linear(p["wk"], x), cfg.n_kv_heads, cfg.head_dim)
    v = _split_heads(linear(p["wv"], x), cfg.n_kv_heads, cfg.head_dim)
    q, k = _position_encode(q, k, cfg, positions)
    # the flash kernel takes contiguous (B, H, S, D) operands
    return q.contiguous(), k.contiguous(), v.contiguous()


def attention_train(p, x, cfg, positions, *, causal: bool = True,
                    kv_override=None):
    """Full-sequence attention.  ``kv_override``: (k, v) already in head
    layout (the whisper decoder's cross-attention); only q is projected,
    and position-encoded only under a rotary ``cfg.rope_type``."""
    if kv_override is None:
        return attention_prefill(p, x, cfg, positions, causal=causal)[0]
    q = _split_heads(linear(p["wq"], x), cfg.n_heads, cfg.head_dim)
    if cfg.rope_type != "none":
        q, _ = _position_encode(q, q, cfg, positions)
    k, v = kv_override
    out = fa_ops.attention(q.contiguous(), k.contiguous(), v.contiguous(),
                           causal=causal, impl=cfg.attn_impl,
                           q_chunk=cfg.attn_q_chunk, k_chunk=cfg.attn_k_chunk)
    return linear(p["wo"], _merge_heads(out))


def attention_prefill(p, x, cfg, positions, *, causal: bool = True):
    """Like train, but also returns the KV cache contents."""
    q, k, v = _qkv(p, x, cfg, positions)
    out = fa_ops.attention(q, k, v, causal=causal, impl=cfg.attn_impl,
                           q_chunk=cfg.attn_q_chunk, k_chunk=cfg.attn_k_chunk)
    return linear(p["wo"], _merge_heads(out)), {"k": k, "v": v}


def attention_decode(p, x, cfg, cache, pos: int, *, kv_override=None):
    """One-token decode.  x: (B, 1, d); cache: {"k","v"} (B, Hkv, S, D);
    pos: the index of this token (the cache holds ``pos`` valid entries
    before the update).  The cache is written in place at ``pos``,
    clamped into range as ``dynamic_update_slice`` clamps its start, and
    returned.  With ``kv_override`` (k, v) in head layout no cache is
    written, every key is valid, and ``cache`` is returned as given."""
    b = x.shape[0]
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    q = _split_heads(linear(p["wq"], x), cfg.n_heads, cfg.head_dim)
    if kv_override is None:
        k_new = _split_heads(linear(p["wk"], x), cfg.n_kv_heads,
                             cfg.head_dim)
        v_new = _split_heads(linear(p["wv"], x), cfg.n_kv_heads,
                             cfg.head_dim)
        q, k_new = _position_encode(q, k_new, cfg, positions)
        k, v = cache["k"], cache["v"]
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
