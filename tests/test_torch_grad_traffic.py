"""The backward pass of the port's block loops writes each block's
gradient once, as the reference's scans over stacked blocks do.

Each loop below takes its blocks from operands that require grad:
``chunked_attention``'s query and key/value blocks, ``_slstm_recurrence``'s
time steps, ``mamba_chunked``'s and ``mlstm_chunked``'s chunks and
``cross_entropy_loss``'s sequence chunks.  A slice taken inside the loop
would have a backward (``slice_backward``/``select_backward``) that
writes a gradient of the operand's whole size for every block, then adds
it into the operand's gradient: traffic that grows with the number of
blocks.  Split once before the loop, autograd gathers the blocks'
gradients in one ``cat``/``stack``.

A ``TorchDispatchMode`` counts, during ``backward()``, the new tensors of
a looped operand's whole shape that the gathering and accumulating ops
(``slice_backward``, ``select_backward``, ``cat``, ``stack``, ``add``)
make.  At 2 and at 8 blocks (or time steps) the count is the same, at
most 2 for each operand of that shape (the gathering, and one addition
where the operand also feeds a path outside the loop), and no slice's
backward runs.  Small widths, f32, on the CPU; the values of these
gradients are held against the reference elsewhere
(``tests/test_torch_optim.py``, the per-family train tests).
"""
import collections
import dataclasses

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.kernels.flash_attention.ops import chunked_attention
from repro_torch.models import layers, mamba, xlstm
from repro_torch.models.transformer import tree

GATHER = ("slice_backward", "select_backward", "cat", "stack", "add")
BLOCK = 4                                   # tokens a block or chunk


class WholeSize(TorchDispatchMode):
    """Counts, by (shape, op), the new tensors of the given shapes that
    the ``GATHER`` ops make."""

    def __init__(self, shapes):
        super().__init__()
        self.shapes = set(shapes)
        self.counts = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.overloadpacket.__name__
        if name in GATHER:
            ins = {id(t.untyped_storage())
                   for t in tree_flatten((args, kwargs))[0]
                   if isinstance(t, torch.Tensor)}
            for t in tree_flatten(out)[0]:
                if isinstance(t, torch.Tensor) and \
                        tuple(t.shape) in self.shapes and \
                        id(t.untyped_storage()) not in ins:
                    self.counts[tuple(t.shape), name] += 1
        return out


@dataclasses.dataclass(frozen=True)
class _MambaCfg:
    d_model: int = 16
    ssm_d_inner: int = 32
    ssm_state: int = 8
    ssm_heads: int = 4
    ssm_d_conv: int = 4
    ssm_chunk: int = BLOCK


@dataclasses.dataclass(frozen=True)
class _XlstmCfg:
    d_model: int = 16
    n_heads: int = 4
    xlstm_d_inner: int = 32
    xlstm_d_conv: int = 4
    xlstm_chunk: int = BLOCK


def _attention(g, n):
    """Causal attention, B 1, H 2, D 8, n query and n key blocks."""
    s = BLOCK * n
    q, k, v = (torch.randn(1, 2, s, 8, generator=g, requires_grad=True)
               for _ in range(3))
    out = chunked_attention(q, k, v, q_chunk=BLOCK, k_chunk=BLOCK)
    return out, [(1, 2, s, 8)] * 3                      # qf, kf, vf


def _slstm(g, n):
    """n time steps, B 2, H 4, dh 8: x_in (B, S, 4d)."""
    x_in = torch.randn(2, n, 128, generator=g, requires_grad=True)
    r = torch.randn(4, 8, 32, generator=g)
    state = (torch.zeros(2, 4, 8), torch.zeros(2, 4, 8),
             torch.full((2, 4, 8), -1e30), torch.zeros(2, 4, 8))
    _, hs = xlstm._slstm_recurrence(r, x_in, state)
    return hs, [(2, n, 128)]


def _mamba(g, n):
    cfg = _MambaCfg()
    s = BLOCK * n
    u = torch.randn(2, s, cfg.d_model, generator=g, requires_grad=True)
    out = mamba.mamba_chunked(tree(mamba.init_mamba(g, cfg)), u, cfg)
    # xf (B, S, H, dh); Bf, Cf (B, S, N); dt, la (B, S, H)
    return out, [(2, s, 4, 8), (2, s, 8), (2, s, 8), (2, s, 4), (2, s, 4)]


def _mlstm(g, n):
    cfg = _XlstmCfg()
    s = BLOCK * n
    u = torch.randn(2, s, cfg.d_model, generator=g, requires_grad=True)
    out = xlstm.mlstm_chunked(tree(xlstm.init_mlstm(g, cfg)), u, cfg)
    # qf, kf, vf (B, S, H, dh); i_pre, f_log (B, S, H)
    return out, [(2, s, 4, 8)] * 3 + [(2, s, 4)] * 2


def _cross_entropy(g, n):
    s = BLOCK * n
    hidden = torch.randn(2, s, 16, generator=g, requires_grad=True)
    w = torch.randn(16, 32, generator=g)
    labels = torch.randint(0, 32, (2, s), generator=g)
    out = layers.cross_entropy_loss(lambda h: h @ w, hidden, labels,
                                    torch.ones(2, s), chunk=BLOCK)
    return out, [(2, s, 16)]


LOOPS = {"chunked_attention": _attention, "slstm_recurrence": _slstm,
         "mamba_chunked": _mamba, "mlstm_chunked": _mlstm,
         "cross_entropy_loss": _cross_entropy}


def _whole_size_outputs(make, n):
    """{operand shape: (how many operands have it, {op: new tensors of
    that shape its backward made})} at n blocks."""
    out, shapes = make(torch.Generator().manual_seed(0), n)
    mode = WholeSize(shapes)
    with mode:
        out.float().sum().backward()
    per_shape = collections.Counter(shapes)
    return {
        shape: (k, {op: c for (sh, op), c in mode.counts.items()
                    if sh == shape})
        for shape, k in per_shape.items()}


@pytest.mark.parametrize("loop", sorted(LOOPS))
def test_a_loop_writes_each_blocks_gradient_once(loop):
    few, many = (_whole_size_outputs(LOOPS[loop], n) for n in (2, 8))
    assert len(few) == len(many)
    for (k, ops_few), (k_many, ops_many) in zip(few.values(), many.values()):
        assert k == k_many
        assert ops_few == ops_many, (loop, ops_few, ops_many)
        assert "slice_backward" not in ops_many
        assert "select_backward" not in ops_many
        assert 1 <= sum(ops_many.values()) <= 2 * k, (loop, ops_many)
