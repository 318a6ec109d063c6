"""Public attention op: the hand-written flash kernel or plain torch paths.

``chunked`` is the online-softmax implementation the models use by
default (the JAX package's ``lax.scan`` path), a loop over query and key
chunks in plain torch; ``pallas`` is the hand-written kernel
(:func:`kernel.flash_attention`) in place of the reference's Pallas one;
``naive`` is the oracle.  The model path does not vmap attention, so the
kernel is called directly and declares no operator.  ``chunked`` and
``naive`` differentiate; the kernel has no backward (nor has the TPU
kernel) and refuses inputs that require grad while grad mode is on.
On ``meta`` tensors ``chunked`` runs three query blocks and three key
blocks of each, the middle ones counted for the rest
(``metatrace.steps``).
"""
import torch
from torch.utils.checkpoint import checkpoint

from ... import metatrace
from . import kernel, ref

__all__ = ["attention", "chunked_attention"]

_NEG_INF = -1e30


def attention(q, k, v, *, causal: bool = True, scale: float | None = None,
              impl: str = "chunked", q_chunk: int = 512, k_chunk: int = 1024):
    if impl == "pallas":
        return kernel.flash_attention(q, k, v, causal=causal, scale=scale)
    if impl == "naive":
        return ref.mha(q, k, v, causal=causal, scale=scale)
    if impl == "chunked":
        return chunked_attention(q, k, v, causal=causal, scale=scale,
                                 q_chunk=q_chunk, k_chunk=k_chunk)
    raise ValueError(f"unknown attention impl {impl!r}")


def chunked_attention(q, k, v, *, causal: bool = True,
                      scale: float | None = None, q_chunk: int = 512,
                      k_chunk: int = 1024):
    """Online-softmax attention over kv chunks, one query chunk at a time.
    Memory: O(bq * bk) scores per (b, h) instead of O(Sq * Skv).
    Supports d_v != d_qk (MLA-style asymmetric heads).

    Differentiable, with the reference's memory behaviour: each query
    block runs under a checkpoint, and each of its kv steps under
    another, so the backward pass recomputes the (bq, bk) score blocks
    instead of keeping them.  The blocks are concatenated, not written
    into a preallocated output, so autograd sees every one."""
    b, hq, sq, d = q.shape
    _, hkv, skv, _ = k.shape
    dv = v.shape[-1]
    if hq != hkv:
        rep = hq // hkv
        k = torch.repeat_interleave(k, rep, dim=1)
        v = torch.repeat_interleave(v, rep, dim=1)
    scale = scale if scale is not None else float(d) ** -0.5
    bq = min(q_chunk, sq)
    bk = min(k_chunk, skv)
    if sq % bq or skv % bk:
        # fall back to one chunk rather than failing on odd lengths
        bq, bk = sq, skv
    kv_off = skv - sq
    qf, kf, vf = q.float(), k.float(), v.float()
    # each operand split into its blocks once, outside the loops: the
    # backward pass then gathers the blocks' gradients once, as the
    # reference's scan over stacked chunks does (a slice taken in the
    # loop would write a whole-size gradient for every block)
    k_blocks = list(zip(range(0, skv, bk), kf.split(bk, 2), vf.split(bk, 2)))

    def kv_step(m, l, acc, qb, kb, vb, q0, k0):
        s = torch.einsum("bhqd,bhkd->bhqk", qb, kb) * scale
        if causal:
            qpos = q0 + torch.arange(bq, device=q.device)[:, None] + kv_off
            kpos = k0 + torch.arange(bk, device=q.device)[None, :]
            s = s.masked_fill(kpos > qpos, _NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum("bhqk,bhkd->bhqd", p, vb)
        return m_new, l, acc

    def q_block(qb, q0):
        m = torch.full((b, hq, bq), _NEG_INF, device=q.device)
        l = torch.zeros((b, hq, bq), device=q.device)
        acc = torch.zeros((b, hq, bq, dv), device=q.device)
        for k0, kb, vb in metatrace.steps(k_blocks, like=qb):
            m, l, acc = checkpoint(metatrace.frozen(kv_step), m, l, acc, qb,
                                   kb, vb, q0, k0, use_reentrant=False)
        l = torch.where(l == 0.0, torch.ones_like(l), l)
        # cast per chunk: the output stays in the compute dtype
        return (acc / l[..., None]).to(q.dtype)

    blocks = metatrace.steps(zip(range(0, sq, bq), qf.split(bq, 2)), like=q)
    return torch.cat(blocks.fill([
        checkpoint(metatrace.frozen(q_block), qb, q0, use_reentrant=False)
        for q0, qb in blocks]), dim=2)
