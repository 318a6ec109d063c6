"""xLSTM blocks: mLSTM (matrix memory, chunkwise-parallel) and sLSTM
(scalar memory, inherently recurrent), arXiv:2405.04517 (the JAX
package's ``models/xlstm.py``).

mLSTM training and prefill use the stabilized chunkwise form: within a
chunk the gated outer-product recurrence is a masked attention-like
quadratic; across chunks the (dk, dv) matrix memory, the normalizer and
the log-space stabilizer are carried.  The reference's ``lax.scan`` over
the chunks is a Python loop here, every chunk product in f32.  Decode is
the O(1) recurrent update.  sLSTM has true recurrent weights (h_{t-1}
feeds the gates), so it runs one step at a time: the reference's
``lax.scan`` over time is a Python loop of S steps, each about 27 eager
operators.  That sequential spine is the architecture's design; the 7:1
mLSTM:sLSTM interleave keeps it to one layer in eight.

Under a mesh the reference runs the sLSTM recurrence inside
``shard_map`` (the recurrent weight's gradient then sums once at the
boundary); that branch comes with the model under a mesh (ROADMAP queue
1 item 12f).  This module takes the reference's no-mesh path.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Linear, Norm, _lead, _param, draw, linear, norm
from .mamba import _causal_conv

__all__ = ["MLSTM", "SLSTM", "init_mlstm", "init_slstm", "mlstm_chunked",
           "mlstm_decode", "mlstm_recurrent_ref", "slstm_scan",
           "slstm_decode"]

_NEG = -1e30


# ---------------------------------------------------------------------------
# mLSTM
class MLSTM(nn.Module):
    """``init_mlstm``: ``up`` d -> 2 d_in, a depthwise ``conv_w`` (K, d_in)
    ~ N(0, 0.1²) with a zero ``conv_b``, per-head block-diagonal ``wq``,
    ``wk``, ``wv`` (H, dh, dh) ~ N(0, 1/dh), ``w_if`` d_in -> 2H, ``skip``
    0.5, an rmsnorm ``out_norm`` over d_in and ``down`` d_in -> d;
    stacked on a leading axis of ``layers``."""

    def __init__(self, cfg, *, layers: int | None = None, device=None):
        super().__init__()
        d, d_in, h = cfg.d_model, cfg.xlstm_d_inner, cfg.n_heads
        lead = _lead(layers)
        kw = dict(layers=layers, device=device)
        self.up = Linear(d, 2 * d_in, **kw)
        self.conv_w = _param(lead + (cfg.xlstm_d_conv, d_in), device)
        self.conv_b = _param(lead + (d_in,), device)
        self.wq = _param(lead + (h, d_in // h, d_in // h), device)
        self.wk = _param(lead + (h, d_in // h, d_in // h), device)
        self.wv = _param(lead + (h, d_in // h, d_in // h), device)
        self.w_if = Linear(d_in, 2 * h, **kw)
        self.skip = _param(lead + (d_in,), device)
        self.out_norm = Norm(d_in, "rmsnorm", **kw)
        self.down = Linear(d_in, d, **kw)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """The bare leaves; the linears and the norm draw their own."""
        self.conv_w.normal_(0.0, 0.1, generator=generator)
        self.conv_b.zero_()
        for w in (self.wq, self.wk, self.wv):
            w.normal_(0.0, w.shape[-1] ** -0.5, generator=generator)
        self.skip.fill_(0.5)


def init_mlstm(generator, cfg, *, layers: int | None = None,
               device=None) -> MLSTM:
    return draw(MLSTM(cfg, layers=layers, device=device), generator)


def _mlstm_qkvif(p, u, cfg, conv_state=None):
    b, s, _ = u.shape
    h, d_in = cfg.n_heads, cfg.xlstm_d_inner
    dh = d_in // h
    up = linear(p["up"], u)
    x_m, z = up[..., :d_in], up[..., d_in:]
    x_c, conv_state = _causal_conv(x_m, p["conv_w"], p["conv_b"],
                                   state=conv_state)
    x_c = F.silu(x_c)

    def headproj(w, t):
        return torch.einsum("bshd,hde->bshe", t.reshape(b, s, h, dh),
                            w.to(t.dtype))

    q = headproj(p["wq"], x_c)
    k = headproj(p["wk"], x_c) * (dh ** -0.5)
    v = headproj(p["wv"], x_m)
    i_f = linear(p["w_if"], x_m).float()
    i_pre, f_pre = i_f[..., :h], i_f[..., h:]              # (B,S,H)
    return q, k, v, i_pre, F.logsigmoid(f_pre), x_c, z, conv_state


def _mlstm_out(p, hs, x_c, z, u):
    hs = hs.reshape(u.shape[0], u.shape[1], -1).to(u.dtype)
    hs = hs + p["skip"].to(u.dtype) * x_c
    hs = norm(p["out_norm"], hs, "rmsnorm") * F.silu(z)
    return linear(p["down"], hs)


def _mlstm_zero_state(u, cfg):
    b, h = u.shape[0], cfg.n_heads
    dh = cfg.xlstm_d_inner // h
    f32 = dict(dtype=torch.float32, device=u.device)
    return (torch.zeros((b, h, dh, dh), **f32),             # C (dk, dv)
            torch.zeros((b, h, dh), **f32),                 # n
            torch.full((b, h), _NEG, **f32))                # m


def mlstm_chunked(p, u, cfg, *, state=None, return_state: bool = False,
                  conv_state=None):
    """u: (B, S, d) -> (B, S, d); with ``return_state`` also the final
    (C, n, m) f32 state and the conv state."""
    s = u.shape[1]
    chunk = min(cfg.xlstm_chunk, s)
    if s % chunk:
        chunk = s
    q, k, v, i_pre, f_log, x_c, z, conv_state = _mlstm_qkvif(
        p, u, cfg, conv_state)
    C, n, m = state if state is not None else _mlstm_zero_state(u, cfg)
    qf, kf, vf = q.float(), k.float(), v.float()
    tri = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool,
                                device=u.device))
    hs = []
    for c0 in range(0, s, chunk):
        c = slice(c0, c0 + chunk)
        qk_, kk_, vk_, ik_ = qf[:, c], kf[:, c], vf[:, c], i_pre[:, c]
        Fc = torch.cumsum(f_log[:, c], 1)                  # (B,L,H)
        # intra logits D[t,s] = F_t - F_s + i_s  (s <= t)
        D = Fc[:, :, None, :] - Fc[:, None, :, :] + ik_[:, None, :, :]
        D = D.masked_fill(~tri[None, :, :, None], _NEG)
        A = Fc + m[:, None, :]                             # inter decay logit
        m_loc = torch.maximum(D.amax(2), A)                # (B,L,H)
        d_w = torch.exp(D - m_loc[:, :, None, :])          # (B,L,L,H)
        a_w = torch.exp(A - m_loc)                         # (B,L,H)
        qk = torch.einsum("blhd,bshd->blsh", qk_, kk_)     # (B,L,L,H)
        w = qk * d_w
        num = torch.einsum("blsh,bshd->blhd", w, vk_) + \
            a_w[..., None] * torch.einsum("blhd,bhde->blhe", qk_, C)
        den = w.sum(2) + a_w * torch.einsum("blhd,bhd->blh", qk_, n)
        hs.append(num / torch.maximum(den.abs(),
                                      torch.exp(-m_loc))[..., None])
        # end-of-chunk state
        Fl = Fc[:, -1]                                     # (B,H)
        w_s = Fl[:, None, :] - Fc + ik_                    # (B,L,H)
        m_new = torch.maximum(Fl + m, w_s.amax(1))
        s_w = torch.exp(w_s - m_new[:, None, :])
        carry = torch.exp(Fl + m - m_new)
        C = C * carry[:, :, None, None] + \
            torch.einsum("blh,blhd,blhe->bhde", s_w, kk_, vk_)
        n = n * carry[:, :, None] + torch.einsum("blh,blhd->bhd", s_w, kk_)
        m = m_new
    out = _mlstm_out(p, torch.cat(hs, 1), x_c, z, u)
    if return_state:
        return out, (C, n, m), conv_state
    return out


def mlstm_decode(p, u, cfg, state, conv_state):
    """One-token update.  state = (C, n, m).  Returns (out, state,
    conv_state), new tensors."""
    C, n, m = state
    q, k, v, i_pre, f_log, x_c, z, conv_state = _mlstm_qkvif(
        p, u, cfg, conv_state)
    qt, kt, vt = q[:, 0].float(), k[:, 0].float(), v[:, 0].float()
    it, ft = i_pre[:, 0], f_log[:, 0]                      # (B,H)
    m_new = torch.maximum(ft + m, it)
    f_w = torch.exp(ft + m - m_new)
    i_w = torch.exp(it - m_new)
    C = C * f_w[..., None, None] + i_w[..., None, None] * \
        kt[..., :, None] * vt[..., None, :]
    n = n * f_w[..., None] + i_w[..., None] * kt
    num = torch.einsum("bhd,bhde->bhe", qt, C)
    den = torch.einsum("bhd,bhd->bh", qt, n)
    hs = num / torch.maximum(den.abs(), torch.exp(-m_new))[..., None]
    return _mlstm_out(p, hs, x_c, z, u), (C, n, m_new), conv_state


def mlstm_recurrent_ref(p, u, cfg):
    """Step-by-step oracle for tests."""
    state = _mlstm_zero_state(u, cfg)
    conv_state = u.new_zeros((u.shape[0], cfg.xlstm_d_conv - 1,
                              cfg.xlstm_d_inner))
    outs = []
    for t in range(u.shape[1]):
        o, state, conv_state = mlstm_decode(p, u[:, t:t + 1], cfg, state,
                                            conv_state)
        outs.append(o)
    return torch.cat(outs, 1)


# ---------------------------------------------------------------------------
# sLSTM
class SLSTM(nn.Module):
    """``init_slstm``: ``w_in`` d -> 4d (z, i, f, o), a per-head
    block-diagonal recurrence ``r`` (H, dh, 4 dh) ~ N(0, 1/dh), an
    rmsnorm ``out_norm`` over d and the gated post-MLP ``up`` d -> d_up,
    ``down`` d_up / 2 -> d, d_up = int(d * 4/3 / 64) * 64 * 2 (2d when
    that is 0); stacked on a leading axis of ``layers``."""

    def __init__(self, cfg, *, layers: int | None = None, device=None):
        super().__init__()
        d, h = cfg.d_model, cfg.n_heads
        dh = d // h
        d_up = int(d * 4 / 3 / 64) * 64 * 2 or 2 * d
        kw = dict(layers=layers, device=device)
        self.w_in = Linear(d, 4 * d, **kw)
        self.r = _param(_lead(layers) + (h, dh, 4 * dh), device)
        self.out_norm = Norm(d, "rmsnorm", **kw)
        self.up = Linear(d, d_up, **kw)
        self.down = Linear(d_up // 2, d, **kw)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        self.r.normal_(0.0, self.r.shape[-2] ** -0.5, generator=generator)


def init_slstm(generator, cfg, *, layers: int | None = None,
               device=None) -> SLSTM:
    return draw(SLSTM(cfg, layers=layers, device=device), generator)


def _slstm_recurrence(r, x_in, state):
    """One step a position over (B, S, 4d) pre-activations, in the
    compute dtype; the gate math upcasts to f32 inside each step.
    Returns (final state, (S, B, H, dh) outputs)."""
    b = x_in.shape[0]
    h, dh = r.shape[0], r.shape[1]
    c, n, m, hp = state
    hs = []
    for t in range(x_in.shape[1]):
        rec = torch.einsum("bhd,hdk->bhk", hp, r)          # (B,H,4dh)
        pre = x_in[:, t].float().reshape(b, h, 4 * dh) + rec
        zt = torch.tanh(pre[..., 0 * dh:1 * dh])
        it = pre[..., 1 * dh:2 * dh]
        ft = F.logsigmoid(pre[..., 2 * dh:3 * dh])
        ot = torch.sigmoid(pre[..., 3 * dh:4 * dh])
        m_new = torch.maximum(ft + m, it)
        f_w = torch.exp(ft + m - m_new)
        i_w = torch.exp(it - m_new)
        c = c * f_w + i_w * zt
        n = n * f_w + i_w
        hp = ot * c / torch.clamp(n, min=1.0)
        m = m_new
        hs.append(hp)
    return (c, n, m, hp), torch.stack(hs)


def slstm_scan(p, u, cfg, *, state=None, return_state: bool = False):
    """u: (B, S, d) -> (B, S, d), one step a position (true recurrence);
    with ``return_state`` also the (c, n, m, h) f32 state."""
    b, s, d = u.shape
    h = cfg.n_heads
    dh = d // h
    # the pre-activations stay in the compute dtype (the loop reads them
    # once a step); the gate math upcasts to f32 inside the step
    x_in = linear(p["w_in"], u)                            # (B,S,4d)
    if state is None:
        f32 = dict(dtype=torch.float32, device=u.device)
        state = (torch.zeros((b, h, dh), **f32),           # c
                 torch.zeros((b, h, dh), **f32),           # n
                 torch.full((b, h, dh), _NEG, **f32),      # m
                 torch.zeros((b, h, dh), **f32))           # h_prev
    state_f, hs = _slstm_recurrence(p["r"].float(), x_in, state)
    hs = hs.transpose(0, 1).reshape(b, s, d).to(u.dtype)
    hs = norm(p["out_norm"], hs, "rmsnorm")
    # gated post-MLP (proj factor ~4/3)
    g, v = linear(p["up"], hs).chunk(2, -1)
    out = linear(p["down"], F.gelu(g, approximate="tanh") * v)
    if return_state:
        return out, state_f
    return out


def slstm_decode(p, u, cfg, state):
    return slstm_scan(p, u, cfg, state=state, return_state=True)
