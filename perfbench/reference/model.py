"""The plain reference: a decoder-only transformer in plain PyTorch.

It follows the equations of the configuration files under
``perfbench/configs`` (dense SwiGLU blocks, or top-k routed SwiGLU
experts), in float32 with TF32 off unless a lower precision is asked for
(the control of ``perfbench/control.py``).  It imports nothing of the
program: it defines the weights it needs by name and shape
(:func:`weight_specs`), and the harness draws them from the seed and
hands the same tensors to both sides.  The names are those of the
program's parameter tree, stacked over the layers, so the harness can
load them into the program's modules by name.

Long sequences are taken in blocks of queries (:func:`attention`), the
loss in blocks of positions, and in training every block runs under
``torch.utils.checkpoint``, so that the reference fits beside nothing
but its own weights and optimizer state.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

__all__ = ["Arith", "Dims", "weight_specs", "hidden_states", "logits_at",
           "loss"]


def tf32_off() -> None:
    """Products in true float32 (the reference's precision)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class Arith:
    """How the reference multiplies: ``"f32"`` in float32, or ``"fp8"``
    with both operands rounded to float8 (e4m3, one scale per tensor,
    products accumulated in float32).  The fp8 rounding passes the
    gradient straight through, so a training step's backward products
    read the rounded operands."""

    def __init__(self, precision: str = "f32"):
        if precision not in ("f32", "fp8"):
            raise ValueError(precision)
        self.precision = precision

    def round(self, x):
        if self.precision == "f32":
            return x
        with torch.no_grad():
            amax = x.detach().abs().amax().clamp(min=1e-30)
            s = amax / 448.0
            q = (x.detach() / s).to(torch.float8_e4m3fn).float() * s
        return x + (q - x).detach()

    def mm(self, a, b):
        return self.round(a) @ self.round(b)


class Dims:
    """The sizes the reference reads from a configuration file's keys."""

    def __init__(self, conf: dict):
        self.n_layers = conf["num_hidden_layers"]
        self.d = conf["hidden_size"]
        self.hq = conf["num_attention_heads"]
        self.hkv = conf["num_key_value_heads"]
        self.dh = conf.get("head_dim") or self.d // self.hq
        self.d_ff = conf["intermediate_size"]
        self.vocab = conf["vocab_size"]
        self.rows = conf.get("padded_vocab_size", self.vocab)
        self.theta = float(conf["rope_theta"])
        self.eps = float(conf["rms_norm_eps"])
        self.tied = bool(conf.get("tie_word_embeddings", False))
        self.experts = conf.get("num_local_experts", 0)
        self.top_k = conf.get("num_experts_per_tok", 0)
        self.renorm = bool(conf.get("norm_topk_prob", True))
        self.stack = "moe_blocks" if self.experts else "blocks"


def weight_specs(dims: Dims) -> dict[str, tuple[tuple, str, float]]:
    """``{name: (shape, init, scale)}`` in the program's names: ``init``
    is ``"normal"`` (standard deviation ``scale``, clipped at two) or
    ``"ones"``.  A linear weight (d_in, d_out) has ``d_in ** -0.5``."""
    L, d, f = dims.n_layers, dims.d, dims.d_ff
    qd, kd = dims.hq * dims.dh, dims.hkv * dims.dh
    s = dims.stack

    def lin(*shape):
        return (shape, "normal", shape[-2] ** -0.5)

    out = {"embed.table": ((dims.rows, d), "normal", 0.02),
           "final_norm.scale": ((d,), "ones", 1.0),
           f"{s}.ln1.scale": ((L, d), "ones", 1.0),
           f"{s}.ln2.scale": ((L, d), "ones", 1.0),
           f"{s}.attn.wq.w": lin(L, d, qd),
           f"{s}.attn.wk.w": lin(L, d, kd),
           f"{s}.attn.wv.w": lin(L, d, kd),
           f"{s}.attn.wo.w": lin(L, qd, d)}
    if not dims.tied:
        out["lm_head.w"] = lin(d, dims.rows)
    if dims.experts:
        e = dims.experts
        out.update({f"{s}.moe.router.w": lin(L, d, e),
                    f"{s}.moe.gate": lin(L, e, d, f),
                    f"{s}.moe.up": lin(L, e, d, f),
                    f"{s}.moe.down": lin(L, e, f, d)})
    else:
        out.update({f"{s}.ffn.gate.w": lin(L, d, f),
                    f"{s}.ffn.up.w": lin(L, d, f),
                    f"{s}.ffn.down.w": lin(L, f, d)})
    return out


def _rms(x, scale, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * scale


def _rope(x, positions, theta):
    """Rotary positions on (B, H, S, D), the halves rotated as pairs."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions.float()[:, None] * freqs              # (S, D/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)


def attention(q, k, v, ar: Arith, block: int = 1024):
    """Causal softmax attention, q (B, Hq, S, D) over k, v (B, Hkv, S, D),
    query head h reading KV head h // (Hq / Hkv); one block of queries
    at a time over every key it sees."""
    b, hq, s, dh = q.shape
    g = hq // k.shape[1]
    k = k.repeat_interleave(g, 1)
    v = v.repeat_interleave(g, 1)
    outs = []
    for q0 in range(0, s, block):
        q1 = min(s, q0 + block)
        sc = ar.mm(q[:, :, q0:q1], k[:, :, :q1].transpose(-1, -2)) * \
            dh ** -0.5
        seen = torch.arange(q1, device=q.device)[None, :] <= \
            torch.arange(q0, q1, device=q.device)[:, None]
        sc = sc.masked_fill(~seen, float("-inf"))
        outs.append(ar.mm(torch.softmax(sc, -1), v[:, :, :q1]))
    return torch.cat(outs, 2)


def _ffn(x, gate, up, down, ar):
    return ar.mm(F.silu(ar.mm(x, gate)) * ar.mm(x, up), down)


def _experts(x, router, gate, up, down, dims: Dims, ar):
    """Top-k routing over every expert, no token dropped: the softmax of
    the router's logits, the k largest gates (the lower expert first
    among equal ones), renormalized to sum to one."""
    xt = x.reshape(-1, x.shape[-1])
    gates = torch.softmax(ar.mm(xt, router), -1)
    vals, idx = torch.sort(gates, dim=-1, descending=True, stable=True)
    topv, topi = vals[:, :dims.top_k], idx[:, :dims.top_k]
    if dims.renorm:
        topv = topv / topv.sum(-1, keepdim=True)
    out = torch.zeros_like(xt)
    for e in range(dims.experts):
        tok, slot = (topi == e).nonzero(as_tuple=True)
        if tok.numel() == 0:
            continue
        y = _ffn(xt[tok], gate[e], up[e], down[e], ar)
        out = out.index_add(0, tok, y * topv[tok, slot, None])
    return out.reshape(x.shape)


def _layer(x, w: dict, i: int, dims: Dims, ar: Arith, positions):
    s = dims.stack
    b, n, _ = x.shape
    h = _rms(x, w[f"{s}.ln1.scale"][i], dims.eps)

    def heads(t, nh):
        return t.reshape(b, n, nh, dims.dh).transpose(1, 2)

    q = heads(ar.mm(h, w[f"{s}.attn.wq.w"][i]), dims.hq)
    k = heads(ar.mm(h, w[f"{s}.attn.wk.w"][i]), dims.hkv)
    v = heads(ar.mm(h, w[f"{s}.attn.wv.w"][i]), dims.hkv)
    q, k = _rope(q, positions, dims.theta), _rope(k, positions, dims.theta)
    a = attention(q, k, v, ar).transpose(1, 2).reshape(b, n, -1)
    x = x + ar.mm(a, w[f"{s}.attn.wo.w"][i])
    h = _rms(x, w[f"{s}.ln2.scale"][i], dims.eps)
    if dims.experts:
        f = _experts(h, w[f"{s}.moe.router.w"][i], w[f"{s}.moe.gate"][i],
                     w[f"{s}.moe.up"][i], w[f"{s}.moe.down"][i], dims, ar)
    else:
        f = _ffn(h, w[f"{s}.ffn.gate.w"][i], w[f"{s}.ffn.up.w"][i],
                 w[f"{s}.ffn.down.w"][i], ar)
    return x + f


def hidden_states(w: dict, dims: Dims, tokens, ar: Arith, *,
                  remat: bool = False):
    """The final normed hidden states (B, S, d) of ``tokens`` (B, S)."""
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    x = F.embedding(tokens.long(), w["embed.table"])
    for i in range(dims.n_layers):
        if remat:
            x = checkpoint(_layer, x, w, i, dims, ar, positions,
                           use_reentrant=False)
        else:
            x = _layer(x, w, i, dims, ar, positions)
    return _rms(x, w["final_norm.scale"], dims.eps)


def head(w: dict, dims: Dims):
    return w["embed.table"].T if dims.tied else w["lm_head.w"]


def logits_at(w: dict, dims: Dims, hidden, ar: Arith):
    """The logits (…, rows) of hidden states (…, d)."""
    return ar.mm(hidden, head(w, dims))


def loss(w: dict, dims: Dims, tokens, ar: Arith, *, block: int = 1024):
    """Next-token cross-entropy, the mean over every position but the
    last of each row; the logits taken ``block`` positions at a time,
    each block under a checkpoint."""
    hid = hidden_states(w, dims, tokens, ar, remat=True)
    labels = tokens[:, 1:].long()
    hid = hid[:, :-1]
    tot = hid.new_zeros(())

    def part(h, y):
        lg = logits_at(w, dims, h, ar)
        return (torch.logsumexp(lg, -1) -
                lg.gather(-1, y[..., None])[..., 0]).sum()

    for s0 in range(0, hid.shape[1], block):
        tot = tot + checkpoint(part, hid[:, s0:s0 + block],
                               labels[:, s0:s0 + block], use_reentrant=False)
    return tot / labels.numel()
