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

The loops over mesh positions follow the same rule: ``attention.attend``
(one call a mesh position, on its (batch, head) chunk),
``xlstm._slstm_sharded`` (the recurrence once a batch shard) and
``moe.moe_ffn_ep`` (one rank's tokens a mesh position) write each
position's chunk of the gradient once, as the reference's partitioned
program writes each device's shard: the same counts on (2, 2) and (4, 1)
meshes of CPU logical devices (for a chunk that splits a GQA group,
(2, 2) and (1, 4)), at most 2 an operand, the zeros an index's backward
adds into, of a batch row or the whole, counted too, and the gradients
those of the same call without a mesh (within 1e-6, relative and
absolute: a shard's products round apart from the whole batch's).
"""
import collections
import dataclasses

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch import dist
from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention.ops import chunked_attention
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import attention, layers, mamba, moe, xlstm
from repro_torch.models.transformer import tree

GATHER = ("slice_backward", "select_backward", "cat", "stack", "add")
BLOCK = 4                                   # tokens a block or chunk


FILL = ("zeros", "new_zeros", "zeros_like")


class WholeSize(TorchDispatchMode):
    """Counts, by (shape, op), the new tensors of the given shapes that
    the ``GATHER`` ops make; with ``fills``, also the zeros made at one
    of the shapes or a batch row of it (the same shape but for the
    first dim), attributed to that shape: the tensor an index's backward
    adds its gradient into."""

    def __init__(self, shapes, fills: bool = False):
        super().__init__()
        self.shapes = set(shapes)
        self.rows = {s[1:]: s for s in self.shapes} if fills else {}
        self.counts = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.overloadpacket.__name__
        if name in FILL and self.rows:
            for t in tree_flatten(out)[0]:
                if isinstance(t, torch.Tensor) and \
                        tuple(t.shape[1:]) in self.rows:
                    self.counts[self.rows[tuple(t.shape[1:])], name] += 1
        elif name in GATHER:
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


# ---------------------------------------------------------------------------
# per mesh position
MESH_SHAPES = [(2, 2), (4, 1)]
# a chunk splits a GQA group on every mesh compared
SPLIT_GROUP_MESHES = [(2, 2), (1, 4)]


def _attend(hkv, skv=64, hq=4):
    """``attend`` over B 4, Hq ``hq`` (Hkv ``hkv``), S 64 (keys ``skv``),
    D 8, its chunk by (data, model); causal where the keys are the
    queries'.  At Hq 8, Hkv 1 the chunk of 4 or 2 query heads of a
    (2, 2) or (1, 4) mesh splits the group of 8, so each query head
    takes its own KV head; Skv 32 there tells K and V, so taken (B, Hq,
    Skv, D), apart from q, and a chunk of them apart from K and V."""
    def run(g, spec):
        q = torch.randn(4, hq, 64, 8, generator=g, requires_grad=True)
        k, v = (torch.randn(4, hkv, skv, 8, generator=g, requires_grad=True)
                for _ in range(2))
        out = attention.attend(q, k, v, spec, causal=skv == 64,
                               impl="chunked", q_chunk=16, k_chunk=16)
        return out, (q, k, v)
    return run, dist.PartitionSpec("data", "model", None, None)


def _slstm(g, spec):
    """``_slstm_sharded`` over x_in (B 4, S 16, 4d 128), its batch by the
    data axis (``attend``'s spec unused); the plain recurrence without a
    mesh."""
    r = torch.randn(4, 8, 32, generator=g)
    x_in = torch.randn(4, 16, 128, generator=g, requires_grad=True)
    state = (torch.zeros(4, 4, 8), torch.zeros(4, 4, 8),
             torch.full((4, 4, 8), -1e30), torch.zeros(4, 4, 8))
    ctx = dist.current()
    _, hs = xlstm._slstm_sharded(r, x_in, state, ctx) if ctx else \
        xlstm._slstm_recurrence(r, x_in, state)
    return hs, (x_in,)


def _moe_ep(g, spec):
    """``moe_ffn_ep`` over x (B 4, S 16, d 128), Granite-3.0-1B-A400M at
    ``reduced()`` (8 experts, drop-free capacity): the tokens by (data,
    EP); the local path without a mesh.  The experts' gradients are
    summed over the data axis, as the reference's data-parallel
    reduction sums them, so x alone is counted."""
    cfg = get_config("granite-moe-1b-a400m").reduced()
    p = tree(moe.init_moe(g, cfg))
    x = torch.randn(4, 16, cfg.d_model, generator=g, requires_grad=True)
    return moe.moe_ffn_ep(p, x, cfg), (x,)


POSITION_LOOPS = {"attend_hkv4": _attend(4), "attend_hkv2": _attend(2),
                  "attend_hkv1": _attend(1, skv=32, hq=8),
                  "slstm_sharded": (_slstm, None),
                  "moe_ffn_ep": (_moe_ep, None)}


def _position_grads(loop, shape):
    """{operand shape: (operands, {op: whole-size new tensors})} and the
    operands' gradients, on a ``shape`` mesh (None: no mesh)."""
    run, spec = POSITION_LOOPS[loop]
    g = torch.Generator().manual_seed(0)
    if shape is None:
        out, operands = run(g, None)
    else:
        mesh = make_mesh(shape, ("data", "model"),
                         dist.logical_devices(4, "cpu"))
        with dist.use_mesh(mesh):
            out, operands = run(g, spec)
    shapes = [tuple(t.shape) for t in operands]
    cot = torch.randn(out.shape, generator=g)
    mode = WholeSize(shapes, fills=True)
    with mode:
        (out * cot).sum().backward()
    counts = {shape: (k, {op: c for (sh, op), c in mode.counts.items()
                          if sh == shape})
              for shape, k in collections.Counter(shapes).items()}
    return counts, [t.grad for t in operands]


@pytest.mark.parametrize("loop", sorted(POSITION_LOOPS))
def test_a_mesh_position_writes_only_its_chunks_gradient(loop):
    _, plain = _position_grads(loop, None)
    counts = []
    for shape in SPLIT_GROUP_MESHES if loop == "attend_hkv1" \
            else MESH_SHAPES:
        got, grads = _position_grads(loop, shape)
        counts.append(got)
        for a, b in zip(grads, plain):
            # a shard's products round apart from the whole batch's
            torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
        for k, ops in got.values():
            assert "slice_backward" not in ops, (loop, shape, ops)
            assert "select_backward" not in ops, (loop, shape, ops)
            assert 1 <= sum(ops.values()) <= 2 * k, (loop, shape, ops)
    assert all(c == counts[0] for c in counts), (loop, counts)
