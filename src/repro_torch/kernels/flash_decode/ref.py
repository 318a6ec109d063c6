"""Plain PyTorch single-token decode attention and its sharded combine
(the JAX package's ``kernels/flash_decode/ref.py``).

Decode attention is memory-bound (the whole KV cache streams past one
query), so BDDT-SCC's placement lesson applies directly: the KV cache is
*striped along the sequence axis* (the "memory controllers"), each shard
computes a partial attention, and the partials combine exactly via
log-sum-exp.
"""
import torch

_NEG_INF = -1e30


def _expand_kv(k, v, hq: int):
    hkv = k.shape[1]
    if hq != hkv:
        rep = hq // hkv
        k = torch.repeat_interleave(k, rep, dim=1)
        v = torch.repeat_interleave(v, rep, dim=1)
    return k, v


def decode_mha(q, k, v, *, scale: float | None = None):
    """q: (B, Hq, D) one new token; k, v: (B, Hkv, S, D) -> (B, Hq, D)."""
    d = q.shape[-1]
    k, v = _expand_kv(k, v, q.shape[1])
    scale = scale if scale is not None else float(d) ** -0.5
    logits = torch.einsum("bhd,bhsd->bhs", q.float(), k.float()) * scale
    w = torch.exp(logits - logits.amax(-1, keepdim=True))
    w = w / w.sum(-1, keepdim=True)
    out = torch.einsum("bhs,bhsd->bhd", w, v.float())
    return out.to(q.dtype)


def decode_partial(q, k, v, *, scale: float | None = None, mask=None):
    """Partial attention over a KV shard.

    Returns (o, lse): o is the shard-normalized output (B, Hq, D) in f32
    and lse the shard log-sum-exp (B, Hq).  ``mask``: optional (B, S)
    bool of valid positions (False entries are padding).
    """
    d = q.shape[-1]
    k, v = _expand_kv(k, v, q.shape[1])
    scale = scale if scale is not None else float(d) ** -0.5
    logits = torch.einsum("bhd,bhsd->bhs", q.float(), k.float()) * scale
    if mask is not None:
        logits = torch.where(mask[:, None, :], logits,
                             torch.full_like(logits, _NEG_INF))
    m = logits.amax(-1, keepdim=True)
    p = torch.exp(logits - m)
    l = p.sum(-1, keepdim=True)
    safe_l = torch.where(l == 0.0, torch.ones_like(l), l)
    o = torch.einsum("bhs,bhsd->bhd", p / safe_l, v.float())
    lse = (m + torch.log(safe_l))[..., 0]
    lse = torch.where(l[..., 0] == 0.0, torch.full_like(lse, _NEG_INF), lse)
    return o, lse


def combine_partials(outs, lses):
    """Combine shard partials: outs (N, B, Hq, D) f32, lses (N, B, Hq)."""
    m = lses.amax(0)
    w = torch.exp(lses - m)                     # (N, B, Hq)
    denom = w.sum(0)
    return (outs * w[..., None]).sum(0) / denom[..., None]
