"""Mixture-of-Experts FFN with expert parallelism (the JAX package's
``models/moe.py``).

Two implementations of top-k token-choice routing:

* :func:`moe_ffn_ref` — exact dense-gather reference (no capacity drops);
  O(N * k * d * d_ff) memory for gathered weights, fine for tests/smoke.
* :func:`moe_ffn_ep` — production path: local counting-sort of
  token-choices into per-expert capacity buckets, an exchange of the
  buckets over the EP (``model``) axis to the experts' owners, expert
  FFN on contiguous buffers, the reverse exchange, local weighted
  un-scatter.  Sort-based dispatch is O(N * k * d) — no one-hot (N, E, C)
  tensors.  With no mesh it is the local computation.

The EP layout *is* the paper's placement story: experts are blocks homed
on "memory controllers" (EP ranks); the router is the allocator striping
tokens across them; the aux loss keeps the stripes balanced; the
exchange is the explicit communication the SCC runtime performs instead
of coherence traffic.

Under a mesh (``repro_torch.dist``), the reference's ``shard_map`` body
runs once per mesh position, on that position's slices of the weights
and tokens, and each ``all_to_all`` becomes an exchange of the (E, C, d)
buffer's chunks between the logical devices of one EP group, both ways.
A chunk that moves between two logical devices is copied, even on one
torch device; ``moe_ffn_ep.exchanged_bytes`` counts the bytes copied.
Expert weights placed by the EP layout (``api.prepare`` pins them, as
the reference's ``_prep_stack`` does) are read from each device's own
chunk; unplaced ones are split once into the EP ranks' shares, and the
tokens once into their blocks, and the output is the blocks'
concatenation: the backward pass gathers each gradient in one ``cat``
instead of writing a whole-size one per device.  Everything is
differentiable.  On ``meta`` tensors the loop over EP groups runs its
first, second and last groups, the second counted for the rest
(``metatrace.steps``).

In an open span recording (``obs.recording``) :func:`moe_ffn_ep` records
``moe/ffn`` (its backward pass ``moe/ffn.bwd``) around ``moe/route``,
``moe/dispatch``, ``moe/experts`` and ``moe/combine``, and each dispatch
counts its token-choices (``moe.choices``, N·k), its bucket slots
(``moe.slots``, E·C) and, as a running maximum on the device, the
fullest expert's choices over C (``moe.peak``).  A checkpoint's
recompute counts again.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .. import dist, metatrace, obs
from .layers import (FFN, Linear, _lead, _param, draw, ffn, joined, linear,
                     pieces)

__all__ = ["MoE", "init_moe", "moe_ffn_ref", "moe_ffn_ep", "moe_ffn",
           "load_balance_loss"]


class MoE(nn.Module):
    """``init_moe``: ``router`` (a linear d -> E), bare ``gate``/``up``
    (E, d, dff) and ``down`` (E, dff, d), and a ``shared`` swiglu FFN of
    width ``d_expert * n_shared_experts`` when the config has shared
    experts; stacked on a leading axis of ``layers``."""

    def __init__(self, cfg, *, layers: int | None = None, device=None):
        super().__init__()
        d, e, dff = cfg.d_model, cfg.n_experts, cfg.d_expert
        lead = _lead(layers)
        self.router = Linear(d, e, layers=layers, device=device)
        self.gate = _param(lead + (e, d, dff), device)
        self.up = _param(lead + (e, d, dff), device)
        self.down = _param(lead + (e, dff, d), device)
        if cfg.n_shared_experts:
            self.shared = FFN(d, dff * cfg.n_shared_experts, "swiglu",
                              layers=layers, device=device)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """The bare expert weights: truncated normal in [-2, 2] times
        ``d ** -0.5`` (gate, up) and ``dff ** -0.5`` (down), the input
        width of each.  The router and the shared FFN draw their own."""
        for w in (self.gate, self.up, self.down):
            nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0,
                                  generator=generator).mul_(
                                      w.shape[-2] ** -0.5)


def init_moe(generator, cfg, *, layers: int | None = None,
             device=None) -> MoE:
    return draw(MoE(cfg, layers=layers, device=device), generator)


def _router(p, xt, cfg):
    """xt: (N, d) -> (topv, topi, gates): (N, k) gates and expert ids, and
    the (N, E) softmax.  The k largest gates with the lower expert first
    among equal ones, as ``lax.top_k`` orders them (a stable descending
    sort; ``torch.topk`` promises no order among ties)."""
    gates = torch.softmax(linear(p["router"], xt).float(), dim=-1)
    vals, idx = torch.sort(gates, dim=-1, descending=True, stable=True)
    topv, topi = vals[:, :cfg.top_k], idx[:, :cfg.top_k]
    if cfg.moe_renorm:
        topv = topv / topv.sum(-1, keepdim=True)
    return topv, topi, gates


def _shared(p, xt):
    return ffn(p["shared"], xt, "swiglu")


def _expert_ffn(xe, gate_w, up_w, down_w, dtype):
    """xe: (E_l, T, d); weights (E_l, d, dff)/(E_l, dff, d)."""
    h = F.silu(torch.bmm(xe, gate_w.to(dtype))) * \
        torch.bmm(xe, up_w.to(dtype))
    return torch.bmm(h, down_w.to(dtype))


# ---------------------------------------------------------------------------
def moe_ffn_ref(p, x, cfg):
    """Exact reference: gather each token's k expert weight blocks."""
    b, s, d = x.shape
    xt = x.reshape(-1, d)
    topv, topi, _ = _router(p, xt, cfg)

    gate, up, down = (dist.gather(p[k]) for k in ("gate", "up", "down"))

    def per_choice(j):
        gw = gate[topi[:, j]].to(x.dtype)               # (N, d, dff)
        uw = up[topi[:, j]].to(x.dtype)
        dw = down[topi[:, j]].to(x.dtype)
        h = F.silu(torch.einsum("nd,ndf->nf", xt, gw)) * \
            torch.einsum("nd,ndf->nf", xt, uw)
        return torch.einsum("nf,nfd->nd", h, dw)

    out = sum(topv[:, j, None].to(x.dtype) * per_choice(j)
              for j in range(cfg.top_k))
    if cfg.n_shared_experts:
        out = out + _shared(p, xt)
    return out.reshape(b, s, d)


# ---------------------------------------------------------------------------
def _capacity(cf: float, n: int, cfg) -> int:
    return max(1, math.ceil(cf * n * cfg.top_k / cfg.n_experts))


def _dispatch_local(xt, topi, e: int, capacity: int, dtype):
    """Counting-sort token-choices into (E, C, d) buckets.  Returns the
    buffer plus (slot, keep) per choice for the un-scatter.  A choice's
    position within its expert is its rank among the choices of that
    expert in flat (token, choice) order; those at or past ``capacity``
    are dropped: written to an extra row past the buffer, as the
    reference's ``.at[...].add(mode="drop")`` sends them out of range.
    Kept slots are distinct, so no two writes meet."""
    n, k = topi.shape
    flat_e = topi.reshape(-1)                           # (N*k,)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    pos_sorted = torch.arange(n * k, device=xt.device) - \
        torch.searchsorted(sorted_e, sorted_e, side="left")
    pos = torch.empty_like(pos_sorted).scatter_(0, order, pos_sorted)
    keep = pos < capacity
    rec = obs.current()
    if rec is not None:
        rec.add("moe.choices", n * k)
        rec.add("moe.slots", e * capacity)
        rec.max("moe.peak", (pos_sorted.max() + 1) / capacity)
    slot = flat_e * capacity + torch.clamp(pos, max=capacity - 1)
    src = torch.arange(n, device=xt.device).repeat_interleave(k)
    target = torch.where(keep, slot, torch.full_like(slot, e * capacity))
    buf = xt.new_zeros((e * capacity + 1, xt.shape[1]), dtype=dtype) \
        .index_add(0, target, xt[src].to(dtype))
    return buf[:-1].reshape(e, capacity, -1), slot, keep


def _unscatter_local(ye_flat, slot, keep, topv, n: int, k: int, dtype):
    """ye_flat: (E*C, d) expert outputs -> (N, d) combined by gates; a
    dropped choice contributes zero."""
    gathered = torch.where(keep[:, None], ye_flat[slot],
                           ye_flat.new_zeros(()))           # (N*k, d)
    w = topv.reshape(-1)[:, None].to(dtype)
    return (gathered * w).reshape(n, k, -1).sum(1)


def _moe_local(p, x, cfg, cf):
    """Single-device sort-based path (identical math, no exchange)."""
    b, s, d = x.shape
    xt = x.reshape(-1, d)
    n_l = xt.shape[0]
    e = cfg.n_experts
    with obs.span("moe/route"):
        topv, topi, _ = _router(p, xt, cfg)
    capacity = _capacity(cf, n_l, cfg)
    with obs.span("moe/dispatch"):
        buf, slot, keep = _dispatch_local(xt, topi, e, capacity, x.dtype)
    with obs.span("moe/experts"):
        ye = _expert_ffn(buf, p["gate"], p["up"], p["down"], x.dtype)
    with obs.span("moe/combine"):
        out = _unscatter_local(ye.reshape(e * capacity, d), slot, keep,
                               topv, n_l, cfg.top_k, x.dtype)
        if cfg.n_shared_experts:
            out = out + _shared(p, xt)
    return out.reshape(b, s, d)


def _move(t, src, dst):
    """``t`` held by logical device ``src`` as ``dst`` holds it: a copy
    when the two differ (counted in ``moe_ffn_ep.exchanged_bytes``), the
    tensor itself when they are one."""
    if src == dst:
        return t
    moe_ffn_ep.exchanged_bytes += \
        t.numel() * t.element_size() * metatrace.multiplier()
    return t.to(dst.torch_device, copy=True)


def _exchange(chunks, group):
    """The tiled ``all_to_all`` over one EP group: ``chunks[i][j]`` is
    what the group's i-th device sends to its j-th; the j-th receives
    their concatenation over i, on its own device."""
    return [torch.cat([_move(chunks[i][j], group[i], group[j])
                       for i in range(len(group))], 0)
            for j in range(len(group))]


def moe_ffn_ep(p, x, cfg, *, capacity_factor: float | None = None):
    """Expert-parallel MoE.  Uses the ambient mesh context; with none it
    is the local path.  Under a mesh, the experts split over
    ``ctx.model_axis``, the batch over ``ctx.all_data_axes`` and the
    sequence over the EP axis when it divides (prefill/train); decode
    (s == 1) replicates over EP — each rank then dispatches the same
    tokens, which is correct and negligible for one token.  Each
    position's capacity counts its own tokens, so drops follow the
    shard.  The output is assembled on ``x``'s device."""
    cf = capacity_factor if capacity_factor is not None \
        else cfg.moe_capacity_factor
    with obs.span("moe/ffn") as sp:
        x, p = sp.enter(x, p)
        if dist.current() is None:
            return sp.exit(_moe_local(p, x, cfg, cf))
        return sp.exit(_moe_ep(p, x, cfg, cf))


def _moe_ep(p, x, cfg, cf):
    """:func:`moe_ffn_ep`'s body under a mesh."""
    ctx = dist.current()
    mesh = ctx.mesh
    ep = ctx.model_axis
    n_ep = ctx.axis_size(ep)
    e = cfg.n_experts
    if e % n_ep:
        raise ValueError(f"{e} experts do not split over {n_ep} EP ranks")
    e_l = e // n_ep
    seq_axis = ep if x.shape[1] % n_ep == 0 else None
    x_index = dist.NamedSharding(
        mesh, dist.PartitionSpec(ctx.all_data_axes, seq_axis, None)) \
        .devices_indices_map(tuple(x.shape))
    w_sharding = dist.NamedSharding(mesh, dist.PartitionSpec(ep, None, None))
    w_index = w_sharding.devices_indices_map(tuple(p["gate"].shape))
    ep_dim = mesh.axis_names.index(ep)
    # one EP group per position of the other axes: its devices in EP order
    groups = np.moveaxis(mesh.devices, ep_dim, -1).reshape(-1, n_ep)

    def on(t, dev):
        if isinstance(t, dict):
            return {k: on(v, dev) for k, v in t.items()}
        return t.to(dev.torch_device)

    # the operands split once into their distinct chunks, so that the
    # backward pass gathers each gradient in one cat: the experts into
    # the EP ranks' shares, the tokens into rows over the data axes (an
    # EP group's), each row into blocks over EP by the group that reads it
    shares = {k: p[k].split(e_l, 0) for k in ("gate", "up", "down")
              if not isinstance(p[k], dist.Placed)}

    def expert_chunk(k, dev):
        w = p[k]
        if not isinstance(w, dist.Placed):
            return on(shares[k][w_index[dev][0].indices(e)[0] // e_l], dev)
        if not w.laid_out_as(w_sharding):
            raise ValueError(f"expert weights placed as {w.sharding.spec} "
                             f"are not the EP layout {w_sharding.spec}")
        return w.shards[dev]

    def start(dev):
        bs, ss, _ = x_index[dev]
        return bs.indices(x.shape[0])[0], ss.indices(x.shape[1])[0]

    b0s = sorted({start(dev)[0] for dev in x_index})
    s0s = sorted({start(dev)[1] for dev in x_index})
    # every position holds an equal shard, so one capacity for all
    b_l, s_l, d = x.shape[0] // len(b0s), x.shape[1] // len(s0s), x.shape[2]
    n_l = b_l * s_l
    capacity = _capacity(cf, n_l, cfg)
    rows = pieces(x, len(b0s), 0)

    # the two all_to_alls: each device sends and receives (E, C, d)
    for _ in range(2):
        dist.record_exchange("all-to-all",
                             e * capacity * d * x.element_size(), n_ep)
    loop = metatrace.steps([(g, rows[b0s.index(start(g[0])[0])])
                            for g in groups], like=x)
    outs = []
    for group, row in loop:
        group = list(group)
        blocks = pieces(row, len(s0s), 1)
        # per rank: route and dispatch its tokens into (E, C, d) buckets
        local = []
        for dev in group:
            xt = on(blocks[s0s.index(start(dev)[1])], dev).reshape(n_l, d)
            with obs.span("moe/route"):
                topv, topi, _ = _router({"router": on(p["router"], dev)},
                                        xt, cfg)
            with obs.span("moe/dispatch"):
                buf, slot, keep = _dispatch_local(xt, topi, e, capacity,
                                                  x.dtype)
            local.append((xt, topv, slot, keep, buf))
        # send expert buckets to their owners: rank i's experts
        # [j*E_l, (j+1)*E_l) go to rank j, concatenated over i
        with obs.span("moe/dispatch"):
            recv = _exchange([r[4].split(e_l, 0) for r in local], group)
        back = []
        for j, dev in enumerate(group):
            # (n_ep, E_l, C, d) -> (E_l, n_ep*C, d)
            rj = recv[j].reshape(n_ep, e_l, capacity, d).transpose(0, 1) \
                .reshape(e_l, n_ep * capacity, d)
            w = [expert_chunk(k, dev) for k in ("gate", "up", "down")]
            with obs.span("moe/experts"):
                ye = _expert_ffn(rj, *w, x.dtype)
            # reverse route: (E_l, n_ep, C, d) -> one chunk per source rank
            back.append(list(ye.reshape(e_l, n_ep, capacity, d)
                             .transpose(0, 1)))
        with obs.span("moe/combine"):
            mine = _exchange(back, group)
        outs.append([])
        for dev, (xt, topv, slot, keep, _), yi in zip(group, local, mine):
            with obs.span("moe/combine"):
                o = _unscatter_local(yi.reshape(e * capacity, d), slot,
                                     keep, topv, n_l, cfg.top_k, x.dtype)
                if cfg.n_shared_experts:
                    o = o + _shared({"shared": on(p["shared"], dev)}, xt)
            outs[-1].append(o.reshape(b_l, s_l, d).to(x.device))
    # each block's output, from the first device that holds it (a block
    # replicated over EP, in decode, is taken once)
    block = {}
    for group, os in zip(groups, loop.fill(outs)):
        for dev, o in zip(group, os):
            block.setdefault(start(dev), o)
    return joined([joined([block[b0, s0] for s0 in s0s], 1) for b0 in b0s], 0)


moe_ffn_ep.exchanged_bytes = 0


def moe_ffn(p, x, cfg):
    if cfg.moe_impl == "ref":
        return moe_ffn_ref(p, x, cfg)
    return moe_ffn_ep(p, x, cfg)


def load_balance_loss(p, x, cfg):
    """Switch-style aux loss: E * sum_e f_e * p_e."""
    d = x.shape[-1]
    xt = x.reshape(-1, d)
    _, topi, gates = _router(p, xt, cfg)
    frac = F.one_hot(topi, cfg.n_experts).float().mean(dim=(0, 1))
    prob = gates.mean(0)
    return cfg.n_experts * torch.sum(frac * prob)
