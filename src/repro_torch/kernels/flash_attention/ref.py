"""Naive-softmax oracle for multi-head attention (small shapes only): the
JAX package's ``kernels/flash_attention/ref.py``."""
import torch


def mha(q, k, v, *, causal: bool = True, scale: float | None = None):
    """q: (B, Hq, Sq, D); k, v: (B, Hkv, Skv, D); GQA via head repetition.

    Returns (B, Hq, Sq, D) in q's dtype; f32 softmax internally.  A row
    that sees no key (causal, Sq > Skv) comes out NaN, as the reference's.
    """
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    if hq != hkv:
        rep = hq // hkv
        k = torch.repeat_interleave(k, rep, dim=1)
        v = torch.repeat_interleave(v, rep, dim=1)
    scale = scale if scale is not None else float(d) ** -0.5
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if causal:
        # query i attends to keys <= i + (skv - sq)  (suffix alignment)
        qpos = torch.arange(sq, device=q.device)[:, None] + (skv - sq)
        kpos = torch.arange(skv, device=q.device)[None, :]
        s = s.masked_fill(kpos > qpos, float("-inf"))
    p = torch.exp(s - s.amax(-1, keepdim=True))
    p = p / p.sum(-1, keepdim=True)
    out = torch.einsum("bhqk,bhkd->bhqd", p, v.float())
    return out.to(q.dtype)
