"""Multi-head Latent Attention (DeepSeek-V2, arXiv:2405.04434), the JAX
package's ``models/mla.py``.

KV states are compressed into a per-token latent ``c_kv`` (kv_lora_rank
wide) plus one shared RoPE key (rope_head_dim); per-head K/V are
up-projections of the latent.  Training and prefill materialize per-head
K/V and run the chunked online-softmax attention with asymmetric head
dims (qk = nope+rope, v = v_head_dim): ``impl="chunked"`` is fixed, as in
the reference, so MLA never reaches the flash kernel.  Decode runs in the
*absorbed* form: queries are pushed through the K up-projection so
attention happens directly against the latent cache — the cache is
(kv_lora_rank + rope_head_dim) per token instead of 2*H*D, BDDT-SCC's
lesson of keeping the data plane small and local.

Under a mesh, ``dist.constrain_heads`` runs on q, k, v and the output as
in the reference, the attention runs once per mesh position on its
(batch, head) chunk (``attention.attend``), and a latent cache placed by
``dist.sharding.cache_shardings`` (the sequence striped over ``model``)
decodes stripe by stripe, merged by ``attention.combine_stripes``: the
cache is never gathered.
"""
from __future__ import annotations

import torch
from torch import nn

from .. import dist
from . import attention as attn_mod
from . import rope as rope_mod
from .layers import Linear, Norm, draw, linear, norm

__all__ = ["MLA", "init_mla", "mla_train", "mla_prefill", "mla_decode"]

_NEG_INF = -1e30


class MLA(nn.Module):
    """``init_mla``: ``wq`` (full-rank queries, as V2-Lite's q_lora_rank
    is 0), ``wkv_a`` (the latent down-projection and the shared rope
    key), ``kv_norm``, the per-head up-projections ``wk_b``/``wv_b``, and
    ``wo``; stacked on a leading axis of ``layers``."""

    def __init__(self, cfg, *, layers: int | None = None, device=None):
        super().__init__()
        d, h = cfg.d_model, cfg.n_heads
        dn, dr, dv = cfg.nope_head_dim, cfg.rope_head_dim, cfg.v_head_dim
        r = cfg.kv_lora_rank
        kw = dict(layers=layers, device=device)
        self.wq = Linear(d, h * (dn + dr), **kw)
        self.wkv_a = Linear(d, r + dr, **kw)
        self.kv_norm = Norm(r, "rmsnorm", **kw)
        self.wk_b = Linear(r, h * dn, **kw)
        self.wv_b = Linear(r, h * dv, **kw)
        self.wo = Linear(h * dv, d, **kw)


def init_mla(generator, cfg, *, layers: int | None = None,
             device=None) -> MLA:
    return draw(MLA(cfg, layers=layers, device=device), generator)


def _project_latent(p, x, cfg, positions):
    """x -> (c_kv normalized, k_rope rotated): the cacheable quantities,
    (B, S, r) and (B, 1, S, dr)."""
    r = cfg.kv_lora_rank
    kv = linear(p["wkv_a"], x)                          # (B, S, r + dr)
    c_kv = norm(p["kv_norm"], kv[..., :r], "rmsnorm")
    k_rope = kv[..., r:][:, None]                       # (B, 1, S, dr)
    k_rope = rope_mod.apply_rope(k_rope, positions, theta=cfg.rope_theta)
    return c_kv, k_rope


def _project_q(p, x, cfg, positions):
    b, s, _ = x.shape
    h, dn, dr = cfg.n_heads, cfg.nope_head_dim, cfg.rope_head_dim
    q = linear(p["wq"], x).reshape(b, s, h, dn + dr).transpose(1, 2)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    q_rope = rope_mod.apply_rope(q_rope, positions, theta=cfg.rope_theta)
    return q_nope, q_rope                               # (B,H,S,dn),(B,H,S,dr)


def mla_train(p, x, cfg, positions, *, causal: bool = True):
    """Materialized path: build per-head K/V from the latent, attend."""
    b, s, _ = x.shape
    h, dn, dr, dv = (cfg.n_heads, cfg.nope_head_dim, cfg.rope_head_dim,
                     cfg.v_head_dim)
    q_nope, q_rope = _project_q(p, x, cfg, positions)
    c_kv, k_rope = _project_latent(p, x, cfg, positions)
    k_nope = linear(p["wk_b"], c_kv).reshape(b, s, h, dn).transpose(1, 2)
    v = linear(p["wv_b"], c_kv).reshape(b, s, h, dv).transpose(1, 2)
    q = torch.cat([q_nope, q_rope], -1)
    spec = dist.constrain_heads(q)
    k = torch.cat([k_nope, k_rope.expand(b, h, s, dr).to(k_nope.dtype)], -1)
    dist.constrain_heads(k)
    dist.constrain_heads(v)
    scale = (dn + dr) ** -0.5
    out = attn_mod.attend(q, k, v, spec, causal=causal, scale=scale,
                          impl="chunked", q_chunk=cfg.attn_q_chunk,
                          k_chunk=cfg.attn_k_chunk)
    dist.constrain_heads(out)
    return linear(p["wo"], out.transpose(1, 2).reshape(b, s, h * dv))


def mla_prefill(p, x, cfg, positions, *, causal: bool = True):
    out = mla_train(p, x, cfg, positions, causal=causal)
    c_kv, k_rope = _project_latent(p, x, cfg, positions)
    return out, {"c_kv": c_kv, "k_rope": k_rope[:, 0]}   # (B,S,r), (B,S,dr)


def mla_decode(p, x, cfg, cache, pos: int):
    """Absorbed decode against the latent cache.

    cache: {"c_kv": (B, S, r), "k_rope": (B, S, dr)}, written in place at
    ``pos``, clamped into range as ``dynamic_update_slice_in_dim`` clamps
    its start, and returned.  A placed cache (under a mesh) decodes
    stripe by stripe (:func:`_latent_attend_striped`).
    scores_h(t) = q_nope_h . (W_uk_h c_t) + q_rope_h . k_rope_t
                = (W_uk_h^T q_nope_h) . c_t + q_rope_h . k_rope_t
    out_h = W_uv_h (sum_t softmax_t c_t)  — all against the latent.
    """
    b = x.shape[0]
    h, dn, dr, dv = (cfg.n_heads, cfg.nope_head_dim, cfg.rope_head_dim,
                     cfg.v_head_dim)
    r = cfg.kv_lora_rank
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    q_nope, q_rope = _project_q(p, x, cfg, positions)   # (B,H,1,dn/dr)
    c_new, k_rope_new = _project_latent(p, x, cfg, positions)
    c_kv, k_rope = cache["c_kv"], cache["k_rope"]       # (B,S,r),(B,S,dr)
    s_len = c_kv.shape[1]
    at = min(max(pos, 0), s_len - 1)
    # absorb q through the K up-projection: (B,H,dn) @ (r,H,dn) -> (B,H,r)
    wk_b = p["wk_b"]["w"].reshape(r, h, dn)
    q_lat = torch.einsum("bhd,rhd->bhr", q_nope[:, :, 0].float(),
                         wk_b.float())
    scale = (dn + dr) ** -0.5
    if isinstance(c_kv, dist.Placed):
        o_lat = _latent_attend_striped(q_lat, q_rope[:, :, 0].float(), c_new,
                                       k_rope_new[:, 0], cache, at, pos,
                                       scale)
    else:
        c_kv[:, at:at + 1] = c_new.to(c_kv.dtype)
        k_rope[:, at:at + 1] = k_rope_new[:, 0].to(k_rope.dtype)
        logits = (torch.einsum("bhr,bsr->bhs", q_lat, c_kv.float()) +
                  torch.einsum("bhd,bsd->bhs", q_rope[:, :, 0].float(),
                               k_rope.float())) * scale
        valid = torch.arange(s_len, device=x.device) <= pos
        logits = logits.masked_fill(~valid, _NEG_INF)
        w = torch.softmax(logits, dim=-1)
        o_lat = torch.einsum("bhs,bsr->bhr", w, c_kv.float())
    wv_b = p["wv_b"]["w"].reshape(r, h, dv)
    o = torch.einsum("bhr,rhv->bhv", o_lat, wv_b.float())
    o = o.reshape(b, 1, h * dv).to(x.dtype)
    return linear(p["wo"], o), cache


def _latent_attend_striped(q_lat, q_rope, c_new, kr_new, cache, at: int,
                           pos: int, scale: float):
    """The absorbed attention over a placed latent cache, one stripe per
    device of the ambient mesh (``attention.decode_stripes``): the
    stripe that holds the clamped position ``at`` is written in place,
    each device scores its own stripe (keys at or before ``pos``) and the
    partials merge.  Returns o_lat (B, H, r) in f32 on ``q_lat``'s
    device."""
    def score(bs, lat, dev):
        on = dev.torch_device
        return (torch.einsum("bhr,bsr->bhs", q_lat[bs].to(on),
                             lat["c_kv"].float()) +
                torch.einsum("bhd,bsd->bhs", q_rope[bs].to(on),
                             lat["k_rope"].float())) * scale

    def value(pr, lat):
        return torch.einsum("bhs,bsr->bhr", pr, lat["c_kv"].float())

    o_lat = q_lat.new_empty(q_lat.shape[:2] + (cache["c_kv"].shape[-1],))
    return attn_mod.decode_stripes(
        {"c_kv": cache["c_kv"], "k_rope": cache["k_rope"]},
        {"c_kv": c_new, "k_rope": kr_new}, cache["c_kv"].sharding.spec, 1,
        at, pos, score, value, o_lat)
