"""Gradient compression: per-tensor int8 quantization with error feedback
(the JAX package's ``optim/compress.py``).

For a cross-node gradient reduction the link is the scarce resource (the
paper's memory-controller contention, one level up).  int8 plus error
feedback cuts the all-reduce payload 4x against f32 (2x against bf16)
while the residual keeps the update unbiased over time.  ``torch.round``
rounds half to even, as ``jnp.round`` does.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from ..models.transformer import tree_map

__all__ = ["ErrorFeedbackState", "ef_init", "compress_int8",
           "decompress_int8", "compress_with_feedback"]


class ErrorFeedbackState(NamedTuple):
    residual: Any


def ef_init(grads) -> ErrorFeedbackState:
    return ErrorFeedbackState(tree_map(
        lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device),
        grads))


def compress_int8(g):
    """g (f32/bf16) -> (int8 values, f32 scale).  Symmetric per-tensor."""
    g32 = g.float()
    scale = torch.clamp(g32.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(g32 / scale), -127, 127).to(torch.int8)
    return q, scale


def decompress_int8(q, scale, dtype=torch.float32):
    return (q.float() * scale).to(dtype)


def compress_with_feedback(grads, ef: ErrorFeedbackState):
    """Returns (tree of (q, scale), new error-feedback state).  The caller
    all-reduces the int8 payloads (summing dequantized values), and the
    residual ``g - dequant(q)`` re-enters the next step's gradients."""
    def one(g, r):
        corrected = g.float() + r
        q, scale = compress_int8(corrected)
        return (q, scale), corrected - decompress_int8(q, scale)

    pairs = _zip_map(one, grads, ef.residual)
    return tree_map(lambda t: t[0], pairs), \
        ErrorFeedbackState(tree_map(lambda t: t[1], pairs))


def _zip_map(fn, a, b):
    if not isinstance(a, dict):
        return fn(a, b)
    return {k: _zip_map(fn, a[k], b[k]) for k in a}
