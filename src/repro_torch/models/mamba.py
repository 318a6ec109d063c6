"""Mamba2 (SSD) block, chunked state-space duality algorithm (the JAX
package's ``models/mamba.py``).

Training and prefill use the SSD chunked form: within a chunk the
recurrence is a masked attention-like quadratic; across chunks a compact
(B, H, N, dh) state is carried.  The reference's ``lax.scan`` over the
chunks is a Python loop here, so only one chunk's (B, L, L, H) decay
tensor is live at a time.  A sequence that the chunk does not divide is
one chunk of its own length, as in the reference.  Every chunk product
is taken in f32.  Decode is the O(1) recurrent update.

The depthwise causal conv is the reference's explicit sum of K shifted
products, in the same order, not ``F.conv1d``: bit-equal to the
reference's in f32.  The reference is jnp here (no Pallas kernel), so
torch ops stand in for it.

Simplifications of the reference, kept: a single B/C group
(``n_groups=1``, as in zamba2-1.2b), zero initial state, softplus dt
with a learned per-head bias.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Linear, Norm, _lead, _param, draw, linear, norm

__all__ = ["Mamba", "init_mamba", "mamba_chunked", "mamba_decode",
           "mamba_recurrent_ref"]


class Mamba(nn.Module):
    """``init_mamba``: ``in_proj`` d -> [z, x, B, C, dt], a depthwise
    ``conv_w`` (K, d_in + 2N) ~ N(0, 0.1²) with a zero ``conv_b``,
    ``A_log = log(1..H)``, ``dt_bias`` 0, ``D`` 1, an rmsnorm
    ``out_norm`` over d_in and ``out_proj`` d_in -> d; stacked on a
    leading axis of ``layers``."""

    def __init__(self, cfg, *, layers: int | None = None, device=None):
        super().__init__()
        d, d_in, n, h = cfg.d_model, cfg.ssm_d_inner, cfg.ssm_state, \
            cfg.ssm_heads
        lead = _lead(layers)
        kw = dict(layers=layers, device=device)
        self.in_proj = Linear(d, 2 * d_in + 2 * n + h, **kw)
        self.conv_w = _param(lead + (cfg.ssm_d_conv, d_in + 2 * n), device)
        self.conv_b = _param(lead + (d_in + 2 * n,), device)
        self.A_log = _param(lead + (h,), device)
        self.dt_bias = _param(lead + (h,), device)
        self.D = _param(lead + (h,), device)
        self.out_norm = Norm(d_in, "rmsnorm", **kw)
        self.out_proj = Linear(d_in, d, **kw)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """The bare leaves; the linears and the norm draw their own."""
        self.conv_w.normal_(0.0, 0.1, generator=generator)
        self.conv_b.zero_()
        h = self.A_log.shape[-1]
        self.A_log.copy_(torch.log(torch.arange(
            1, h + 1, dtype=torch.float32, device=self.A_log.device)))
        self.dt_bias.zero_()
        self.D.fill_(1.0)


def init_mamba(generator, cfg, *, layers: int | None = None,
               device=None) -> Mamba:
    return draw(Mamba(cfg, layers=layers, device=device), generator)


def _causal_conv(x, w, b, *, state=None):
    """Depthwise causal conv1d.  x: (B, S, C); w: (K, C).  With ``state``
    (B, K-1, C) given, acts as a streaming step.  Returns (y, the last
    K-1 inputs)."""
    w = w.to(x.dtype)
    b = b.to(x.dtype)
    k = w.shape[0]
    s = x.shape[1]
    pad = x.new_zeros((x.shape[0], k - 1, x.shape[2])) if state is None \
        else state.to(x.dtype)
    xp = torch.cat([pad, x], 1)                         # (B, S+K-1, C)
    y = xp[:, 0:s] * w[0]
    for i in range(1, k):
        y = y + xp[:, i:i + s] * w[i]
    y = y + b
    return y, (xp[:, -(k - 1):] if k > 1 else None)


def _split_proj(p, u, cfg):
    d_in, n, h = cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_heads
    zxbcdt = linear(p["in_proj"], u)
    return (zxbcdt[..., :d_in], zxbcdt[..., d_in:2 * d_in + 2 * n],
            zxbcdt[..., -h:])


def _gates(p, dt_raw):
    dt = F.softplus(dt_raw.float() + p["dt_bias"].float())     # (..., H)
    a = -torch.exp(p["A_log"].float())                         # (H,)
    return dt, dt * a                                          # log decay


def _conv_inputs(p, u, cfg, conv_state):
    """in_proj, the conv and its silu: (z, x, B, C, dt, log decay, new
    conv state), x as (B, S, H, dh)."""
    b, s, _ = u.shape
    d_in, n, h = cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_heads
    z, xbc, dt_raw = _split_proj(p, u, cfg)
    xbc, conv_state = _causal_conv(xbc, p["conv_w"], p["conv_b"],
                                   state=conv_state)
    xbc = F.silu(xbc)
    x = xbc[..., :d_in].reshape(b, s, h, d_in // h)
    dt, la = _gates(p, dt_raw)
    return (z, x, xbc[..., d_in:d_in + n], xbc[..., d_in + n:], dt, la,
            conv_state)


def _out(p, y, x, z, u):
    """The skip through D, the gate, the norm and out_proj."""
    b, s = u.shape[:2]
    y = y + x.float() * p["D"].float()[:, None]
    y = y.reshape(b, s, -1).to(u.dtype)
    y = norm(p["out_norm"], y * F.silu(z), "rmsnorm")
    return linear(p["out_proj"], y)


def mamba_chunked(p, u, cfg, *, state=None, conv_state=None,
                  return_state: bool = False):
    """u: (B, S, d_model) -> (B, S, d_model), the SSD chunked scan; with
    ``return_state`` also the final (B, H, N, dh) f32 state and the conv
    state (B, K-1, d_in + 2N)."""
    b, s, _ = u.shape
    d_in, n, h = cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_heads
    chunk = min(cfg.ssm_chunk, s)
    if s % chunk:
        chunk = s

    z, x, Bm, Cm, dt, la, conv_state = _conv_inputs(p, u, cfg, conv_state)
    xf, Bf, Cf = x.float(), Bm.float(), Cm.float()
    st = state if state is not None else \
        u.new_zeros((b, h, n, d_in // h), dtype=torch.float32)
    tri = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool,
                                device=u.device))
    ys = []
    for c0 in range(0, s, chunk):
        c = slice(c0, c0 + chunk)
        xk, bk, ck, dk, lk = xf[:, c], Bf[:, c], Cf[:, c], dt[:, c], la[:, c]
        cum = torch.cumsum(lk, 1)                              # (B,L,H)
        total = cum[:, -1]                                     # (B,H)
        # intra-chunk masked quadratic
        gap = cum[:, :, None, :] - cum[:, None, :, :]          # (B,L,L,H)
        gap = gap.masked_fill(~tri[None, :, :, None], -math.inf)
        cb = torch.einsum("btn,bsn->bts", ck, bk)              # (B,L,L)
        m = torch.exp(gap) * (cb[..., None] * dk[:, None, :, :])
        y = torch.einsum("btsh,bshd->bthd", m, xk)
        # inter-chunk: read the carried state
        y = y + torch.einsum("btn,bhnd->bthd", ck, st) * \
            torch.exp(cum)[..., None]
        # the new carried state
        w_state = torch.exp(total[:, None, :] - cum) * dk      # (B,L,H)
        s_c = torch.einsum("blh,bln,blhd->bhnd", w_state, bk, xk)
        st = st * torch.exp(total)[:, :, None, None] + s_c
        ys.append(y)
    out = _out(p, torch.cat(ys, 1), x, z, u)
    if return_state:
        return out, st, conv_state
    return out


def mamba_decode(p, u, cfg, state, conv_state):
    """One-token recurrent update.  u: (B, 1, d); state (B, H, N, dh)
    f32; conv_state (B, K-1, d_in + 2N).  Returns (out, state,
    conv_state), new tensors."""
    z, x, Bm, Cm, dt, la, conv_state = _conv_inputs(p, u, cfg, conv_state)
    xt = x[:, 0].float()                                       # (B,H,dh)
    Bt, Ct = Bm[:, 0].float(), Cm[:, 0].float()                # (B,N)
    dec = torch.exp(la[:, 0])                                  # (B,H)
    state = state * dec[:, :, None, None] + torch.einsum(
        "bn,bhd,bh->bhnd", Bt, xt, dt[:, 0])
    y = torch.einsum("bn,bhnd->bhd", Ct, state)
    return _out(p, y[:, None], x, z, u), state, conv_state


def mamba_recurrent_ref(p, u, cfg):
    """Step-by-step oracle for tests."""
    b, s, _ = u.shape
    d_in, n, h = cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_heads
    state = u.new_zeros((b, h, n, d_in // h), dtype=torch.float32)
    conv_state = u.new_zeros((b, cfg.ssm_d_conv - 1, d_in + 2 * n))
    outs = []
    for t in range(s):
        o, state, conv_state = mamba_decode(p, u[:, t:t + 1], cfg, state,
                                            conv_state)
        outs.append(o)
    return torch.cat(outs, 1)
