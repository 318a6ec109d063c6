"""Rotary position embeddings: standard RoPE and Qwen2-VL's M-RoPE, and
Whisper's sinusoidal positions (the JAX package's ``models/rope.py``).

M-RoPE splits the head dimension into (temporal, height, width) sections,
each rotated by its own position stream.  For the text/stub modality the
three streams coincide, but the section machinery is implemented
faithfully so real (t, h, w) streams drop in.
"""
from __future__ import annotations

import torch


def rope_freqs(d_head: int, theta: float = 1e4, device=None):
    return theta ** (-torch.arange(0, d_head // 2, dtype=torch.float32,
                                   device=device) / (d_head // 2))


def _rotate(x, ang):
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)
    return out.to(x.dtype)


def apply_rope(x, positions, *, theta: float = 1e4):
    """x: (B, H, S, D); positions: (B, S) int."""
    freqs = rope_freqs(x.shape[-1], theta, device=x.device)     # (D/2,)
    ang = positions[:, None, :, None].float() * freqs           # (B,1,S,D/2)
    return _rotate(x, ang)


def apply_mrope(x, positions_thw, sections, *, theta: float = 1e4):
    """x: (B, H, S, D); positions_thw: (3, B, S); sections: per-stream
    half-dim sizes summing to D/2 (Qwen2-VL: (16, 24, 24) for D=128)."""
    d = x.shape[-1]
    if sum(sections) != d // 2:
        raise ValueError(f"sections {sections} do not sum to {d // 2}")
    freqs = rope_freqs(d, theta, device=x.device)
    parts = []
    off = 0
    for s_idx, sec in enumerate(sections):
        pos = positions_thw[s_idx]                              # (B, S)
        parts.append(pos[:, None, :, None].float() * freqs[off:off + sec])
        off += sec
    return _rotate(x, torch.cat(parts, -1))                     # (B,1,S,D/2)


def sinusoidal_positions(seq: int, d_model: int, device=None):
    """Whisper-style fixed sinusoidal embeddings (S, D)."""
    pos = torch.arange(seq, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(d_model // 2, dtype=torch.float32,
                       device=device)[None, :]
    ang = pos / (1e4 ** (dim / (d_model // 2)))
    return torch.cat([torch.sin(ang), torch.cos(ang)], -1)


def sinusoidal_position_at(pos, d_model: int, device=None):
    """One sinusoidal embedding row for a scalar position."""
    dim = torch.arange(d_model // 2, dtype=torch.float32, device=device)
    ang = torch.as_tensor(pos, dtype=torch.float32, device=device)
    ang = ang / (1e4 ** (dim / (d_model // 2)))
    return torch.cat([torch.sin(ang), torch.cos(ang)], -1)
