"""Training attention: which calls take the hand-written kernel pair
(``kernels/flash_attention/train.py``, ``csrc/flash_attention_train.cu``),
the pair's mathematics in plain PyTorch against autograd through the
chunked path, and (``cuda``-marked, skipped without a card) the kernels
themselves against the chunked path and an f32 oracle.

The card's tests hold the kernels' error against the f32 oracle ``ref.mha``
to at most 1.1 times the chunked path's own error plus one bf16 ulp of the
tensor's largest value, and hold the precision of the hi + lo split: the
forward's f32 output within 2^-14 of its plain version's, normwise, and
the gradients within 2^-10 (a build without the lo products misses both
by far).  Run them with
``python -m pytest -m cuda tests/test_torch_attn_train.py``.
On ``meta`` tensors a qualifying call allocates what the kernels allocate
and is counted as the chunked path: the flop counter's count equals the
chunked path's, op by op, with and without a remat checkpoint around it.
"""
import math

import pytest
import torch

from torch.utils.checkpoint import checkpoint

from repro_torch import metatrace, obs
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import ops, ref, train
from repro_torch.launch.flopcount import FlopCounter
from repro_torch.launch.hlo_stats import LiveBytes
from repro_torch.models import attention

BF16 = torch.bfloat16

# ---------------------------------------------------------------------------
# the dispatch rule
_Q, _KV = (2, 8, 64, 128), (2, 2, 64, 128)


@pytest.mark.parametrize("device,dtype,q,k,v,causal,takes", [
    ("cuda", BF16, _Q, _KV, _KV, True, True),
    ("cuda", BF16, _Q, _KV, _KV, False, True),
    ("cpu", BF16, _Q, _KV, _KV, True, False),
    ("meta", BF16, _Q, _KV, _KV, True, False),
    ("mixed", BF16, _Q, _KV, _KV, True, False),
    ("cuda", torch.float32, _Q, _KV, _KV, True, False),
    ("cuda", torch.float16, _Q, _KV, _KV, True, False),
    ("cuda", None, _Q, _KV, _KV, True, False),
    # MLA's asymmetric heads: v's head dim differs from q's
    ("cuda", BF16, _Q, _KV, (2, 2, 64, 64), True, False),
    # head dims the kernels do not take
    ("cuda", BF16, (1, 4, 64, 96), (1, 4, 64, 96), (1, 4, 64, 96), True,
     False),
    ("cuda", BF16, (1, 4, 64, 256), (1, 4, 64, 256), (1, 4, 64, 256), True,
     False),
    # causal with more queries than keys: a row would see no key
    ("cuda", BF16, (1, 4, 80, 64), (1, 4, 64, 64), (1, 4, 64, 64), True,
     False),
    ("cuda", BF16, (1, 4, 80, 64), (1, 4, 64, 64), (1, 4, 64, 64), False,
     True),
    ("cuda", BF16, (1, 4, 64, 64), (1, 4, 80, 64), (1, 4, 80, 64), True,
     True),
    # groups: G 1, G 8, a group that does not divide, G above a tile
    ("cuda", BF16, (1, 6, 32, 64), (1, 6, 32, 64), (1, 6, 32, 64), True,
     True),
    ("cuda", BF16, (1, 64, 32, 128), (1, 8, 32, 128), (1, 8, 32, 128), True,
     True),
    ("cuda", BF16, (1, 6, 32, 64), (1, 4, 32, 64), (1, 4, 32, 64), True,
     False),
    ("cuda", BF16, (1, 128, 32, 64), (1, 1, 32, 64), (1, 1, 32, 64), True,
     False),
    # k and v of another batch or shape than q's
    ("cuda", BF16, _Q, (1, 2, 64, 128), (1, 2, 64, 128), True, False),
    ("cuda", BF16, _Q, _KV, (2, 2, 32, 128), True, False),
    ("cuda", BF16, (2, 8, 64), (2, 2, 64), (2, 2, 64), True, False),
])
def test_takes_kernels(device, dtype, q, k, v, causal, takes):
    assert train.takes_kernels(device, dtype, q, k, v, causal) is takes


def _qkv(b, hq, hkv, sq, skv, d, dtype=BF16, seed=0):
    """q, k, v and an output gradient of bf16-representable values."""
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(shape, generator=g).to(BF16).to(dtype)
            for shape in ((b, hq, sq, d), (b, hkv, skv, d), (b, hkv, skv, d),
                          (b, hq, sq, d))]


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_cpu_and_meta_take_the_chunked_path(monkeypatch, device):
    """On the CPU and on ``meta`` tensors ``chunked`` runs the torch loop
    (on ``meta`` inside the pair's ``meta`` rule, which counts it): the
    kernel pair's function is never called, and no counter moves."""
    def refuse(*a, **kw):
        raise AssertionError("the kernel pair was called")
    monkeypatch.setattr(train, "flash_attention_train", refuse)
    q, k, v, _ = (x.to(device) for x in _qkv(1, 4, 2, 32, 32, 64))
    with obs.recording() as rec:
        out = ops.attention(q, k, v, causal=True, impl="chunked",
                            q_chunk=16, k_chunk=16)
    assert out.shape == q.shape and out.device.type == device
    assert "attn.fused" not in rec.counters
    assert "attn.chunked" not in rec.counters


def test_a_call_that_qualifies_takes_the_pair_and_counts(monkeypatch):
    """Where the rule holds, ``chunked`` calls the kernel pair's function
    (its plain version on this CPU) and adds 1 to ``attn.fused``."""
    monkeypatch.setattr(train, "takes_kernels", lambda *a: True)
    q, k, v, _ = _qkv(1, 4, 2, 32, 32, 64)
    before = dict(train.flash_attention_train.launches_by_kernel)
    with obs.recording() as rec:
        for _ in range(3):
            out = ops.attention(q, k, v, causal=True, impl="chunked")
    assert rec.counters == {"attn.fused": 3}
    want = train.forward_plain(q, k, v, causal=True, scale=64 ** -0.5)[0]
    assert torch.equal(out, want)
    # the plain version launches nothing
    assert train.flash_attention_train.launches_by_kernel == before


def test_train_kernels_are_counted_by_name():
    assert train.KERNELS == ("train_fwd", "train_delta", "train_dq",
                             "train_dkdv")
    assert set(train.flash_attention_train.launches_by_kernel) == \
        set(train.KERNELS)
    assert "flash_attention_train" in _build.SOURCES
    # the serving roofline matches this substring: the training kernels
    # must not carry it
    for name in _build.TENSOR_CORE_SASS["flash_attention_train"]:
        assert "flash_attention_bf16_kernel" not in name


# ---------------------------------------------------------------------------
# the kernel pair's mathematics in plain PyTorch
_SHAPES = [(2, 4, 2, 64, 64, 32, True),     # G 2
           (1, 8, 1, 40, 72, 64, True),     # G 8, Sq < Skv
           (1, 3, 3, 50, 30, 32, False),    # G 1, non-causal, Sq > Skv
           (1, 6, 2, 17, 17, 128, True),    # G 3, D 128
           (1, 4, 1, 33, 33, 64, False)]    # G 4, non-causal


def _through(fn, q, k, v, do):
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    out = fn(*leaves)
    return (out.detach(),) + torch.autograd.grad(out, leaves, do)


@pytest.mark.parametrize("b,hq,hkv,sq,skv,d,causal", _SHAPES)
def test_plain_pair_matches_chunked_autograd(b, hq, hkv, sq, skv, d,
                                             causal):
    """In f32 on bf16-representable values the explicit formulas (lse,
    delta, dS, the hi + lo split) give autograd's output and gradients
    through ``chunked_attention`` to the split's 2^-17 and f32 sums."""
    q, k, v, do = _qkv(b, hq, hkv, sq, skv, d, torch.float32)
    want = _through(lambda *x: ops.chunked_attention(
        *x, causal=causal, q_chunk=16, k_chunk=16), q, k, v, do)
    got = _through(lambda *x: train.flash_attention_train(
        *x, causal=causal), q, k, v, do)
    for name, g, w in zip(("o", "dq", "dk", "dv"), got, want):
        assert g.dtype == w.dtype == torch.float32, name
        err = (g - w).abs().max() / w.abs().max()
        assert err < 2e-5, (name, float(err))


def _ulp(x: torch.Tensor) -> float:
    """One bf16 ulp of the largest |x|."""
    return 2.0 ** (math.floor(math.log2(float(x.abs().max()))) - 7)


@pytest.mark.parametrize("b,hq,hkv,sq,skv,d,causal", _SHAPES)
def test_plain_pair_in_bf16_is_as_close_to_f32_as_chunked(b, hq, hkv, sq,
                                                          skv, d, causal):
    """The card's criterion, on the plain version: against the f32 oracle,
    the pair's error is at most 1.1 times the chunked path's plus one bf16
    ulp of the tensor's largest value."""
    q, k, v, do = _qkv(b, hq, hkv, sq, skv, d, seed=1)
    oracle = _through(lambda *x: ref.mha(*x, causal=causal),
                      *(t.float() for t in (q, k, v, do)))
    chunked = _through(lambda *x: ops.chunked_attention(
        *x, causal=causal, q_chunk=16, k_chunk=16), q, k, v, do)
    pair = _through(lambda *x: train.flash_attention_train(
        *x, causal=causal), q, k, v, do)
    for name, p, c, r in zip(("o", "dq", "dk", "dv"), pair, chunked,
                             oracle):
        assert p.dtype == BF16, name
        e_pair = float((p.float() - r).abs().max())
        e_chunked = float((c.float() - r).abs().max())
        assert e_pair <= 1.1 * e_chunked + _ulp(r), (name, e_pair,
                                                     e_chunked)


def test_lse_is_the_base_2_log_sum_exp():
    q, k, v, _ = _qkv(1, 4, 2, 24, 40, 32, torch.float32)
    scale = 0.3
    _, _, lse = train.forward_plain(q, k, v, causal=True, scale=scale)
    s = q @ torch.repeat_interleave(k, 2, dim=1).transpose(-1, -2) * scale
    hidden = torch.arange(40)[None, :] > torch.arange(24)[:, None] + 16
    want = torch.logsumexp(s.masked_fill(hidden, -torch.inf), -1) / \
        math.log(2)
    torch.testing.assert_close(lse, want, rtol=1e-5, atol=1e-5)


def test_the_split_leaves_2_to_the_minus_17():
    g = torch.Generator().manual_seed(3)
    x = torch.rand(64, 64, generator=g)
    y = torch.randn(64, 32, generator=g).to(BF16).float()
    err = (train._split_mm(x, y) - x.double() @ y.double()).abs()
    assert bool((err <= 2.0 ** -16 * (x.abs() @ y.abs()).double() +
                 1e-6).all())


# ---------------------------------------------------------------------------
# on ``meta``: the card's allocations, the chunked path's count
def _meta_trace(fn, remat: bool, b=1, hq=4, hkv=2, s=256, d=64):
    """The flop counter and the live-bytes tracker over one forward and
    backward of ``fn`` on ``meta`` bf16 operands (blocks of 32 queries and
    64 keys: both loops shortened), under a remat checkpoint with an op
    after attention, as a model block has, when ``remat``."""
    q, k, v = (torch.empty(shape, dtype=BF16, device="meta",
                           requires_grad=True)
               for shape in ((b, hq, s, d), (b, hkv, s, d), (b, hkv, s, d)))
    do = torch.empty((b, hq, s, d), dtype=BF16, device="meta")

    def attend(x, k_, v_):
        # operands made inside the block, as a layer's projections are:
        # under remat their storage is freed after the forward
        return fn(x * 2.0, k_ * 2.0, v_ * 2.0, q_chunk=32, k_chunk=64) * x

    metatrace.clear()
    flops, live = FlopCounter(), LiveBytes()
    with flops, live:
        x = q * 1.0
        out = checkpoint(metatrace.frozen(attend), x, k, v,
                         use_reentrant=False) if remat else attend(x, k, v)
        torch.autograd.grad(out, (q, k, v), do)
    metatrace.clear()
    return flops, live


@pytest.mark.parametrize("remat", [False, True])
def test_meta_counts_the_chunked_path(remat):
    """A qualifying call on ``meta`` counts the chunked path's flops and
    bytes, op by op, and holds less than it."""
    pair = _meta_trace(ops.attention, remat)
    chunked = _meta_trace(ops.chunked_attention, remat)
    assert pair[0].by_op == chunked[0].by_op
    assert (pair[0].flops, pair[0].bytes) == (chunked[0].flops,
                                              chunked[0].bytes)
    assert pair[0].flops > 0
    assert pair[1].peak < chunked[1].peak
    assert pair[1].live == chunked[1].live == 0


class _Allocates(torch.autograd.Function):
    """Only what the kernels allocate: o, o32 and lse, saved with q, k and
    v; then delta, dq, dk and dv."""

    @staticmethod
    def forward(ctx, q, k, v):
        o32 = torch.empty(q.shape, dtype=torch.float32, device=q.device)
        lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
        ctx.save_for_backward(q, k, v, o32, lse)
        return torch.empty_like(q)

    @staticmethod
    def backward(ctx, do):
        q, k, v, _, lse = ctx.saved_tensors
        delta = torch.empty_like(lse)
        dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
        del delta
        return dq, dk, dv


@pytest.mark.parametrize("remat", [False, True])
def test_meta_holds_what_the_kernels_allocate(remat):
    """The live bytes of a qualifying call on ``meta`` are those of a
    function that allocates what the kernels allocate and nothing else:
    nothing of the chunked path's loop is held."""
    pair = _meta_trace(ops.attention, remat)[1]
    alone = _meta_trace(lambda q, k, v, **_: _Allocates.apply(q, k, v),
                        remat)[1]
    assert (pair.peak, pair.live) == (alone.peak, alone.live)
    assert pair.peak > 0


# ---------------------------------------------------------------------------
# on the card
@pytest.fixture
def cuda_device():
    """The card, or a skip: decided when the test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    if _build.nvcc_path() is None:
        pytest.skip("needs nvcc to build the kernels")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", torch.cuda.current_device())


def _card_qkv(dev, b, hq, hkv, sq, skv, d, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(shape, generator=g, device=dev).to(BF16)
            for shape in ((b, hq, sq, d), (b, hkv, skv, d), (b, hkv, skv, d),
                          (b, hq, sq, d))]


# the cells' shapes (Granite D 64 G 2 at B 1-2 x 4,096; Mistral D 128 G 4
# at 1,024 and 4,096), G 1 and G 8, non-causal, Sq < Skv
_CARD_SHAPES = [(1, 16, 8, 4096, 4096, 64, True),
                (2, 16, 8, 4096, 4096, 64, True),
                (2, 32, 8, 1024, 1024, 128, True),
                (1, 32, 8, 4096, 4096, 128, True),
                (2, 32, 32, 1024, 1024, 64, True),
                (1, 64, 8, 1024, 1024, 128, True),
                (2, 6, 6, 1280, 1280, 64, False),
                (2, 6, 6, 224, 1280, 64, False),
                (1, 32, 8, 512, 1536, 128, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,hq,hkv,sq,skv,d,causal", _CARD_SHAPES)
def test_cuda_pair_is_as_close_to_f32_as_chunked(cuda_device, b, hq, hkv,
                                                 sq, skv, d, causal):
    q, k, v, do = _card_qkv(cuda_device, b, hq, hkv, sq, skv, d)
    assert train.takes_kernels("cuda", BF16, q.shape, k.shape, v.shape,
                               causal)
    before = dict(train.flash_attention_train.launches_by_kernel)
    pair = _through(lambda *x: ops.attention(*x, causal=causal), q, k, v,
                    do)
    after = train.flash_attention_train.launches_by_kernel
    assert {n: after[n] - before[n] for n in train.KERNELS} == \
        dict.fromkeys(train.KERNELS, 1)
    chunked = _through(lambda *x: ops.chunked_attention(*x, causal=causal),
                       q, k, v, do)
    oracle = _through(lambda *x: ref.mha(*x, causal=causal),
                      *(t.float() for t in (q, k, v, do)))
    torch.cuda.synchronize()
    for name, p, c, r in zip(("o", "dq", "dk", "dv"), pair, chunked,
                             oracle):
        assert p.dtype == BF16 and bool(torch.isfinite(p).all()), name
        e_pair = float((p.float() - r).abs().max())
        e_chunked = float((c.float() - r).abs().max())
        assert e_pair <= 1.1 * e_chunked + _ulp(r), (name, e_pair,
                                                     e_chunked)


@pytest.mark.cuda
def test_cuda_pair_matches_its_plain_version(cuda_device):
    """The kernels against their plain version on the card, o and lse
    included, at a shape with ragged tiles (G 3, Sq 100 < Skv 164)."""
    q, k, v, do = _card_qkv(cuda_device, 2, 6, 2, 100, 164, 128)
    scale = 128 ** -0.5
    o, o32, lse = train._forward_kernel(q, k, v, True, scale)
    want_o, want_o32, want_lse = train.forward_plain(q, k, v, causal=True,
                                                     scale=scale)
    grads = train._backward_kernel(q, k, v, o32, lse, do, True, scale)
    want = train.backward_plain(q, k, v, o32, lse, do, causal=True,
                                scale=scale)
    torch.cuda.synchronize()
    torch.testing.assert_close(lse, want_lse, rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(o32, want_o32, rtol=1e-5, atol=1e-5)
    assert torch.equal(o, o32.to(BF16))
    for got, w in zip((o,) + grads, (want_o,) + want):
        assert float((got.float() - w.float()).abs().max()) <= _ulp(w)


def _normgap(x, want) -> float:
    want = want.float()
    return float((x.float() - want).norm() / want.norm())


# the hi + lo split's precision against the plain version, normwise: the
# forward's f32 output, and the bf16 gradients.  Here the kernels read at
# most 3.8e-6 and 5.8e-4, a build without the lo products at least 1.2e-3
# and 2.5e-3 (PERF.md)
_SPLIT_O32_TOL, _SPLIT_GRAD_TOL = 2.0 ** -14, 2.0 ** -10


@pytest.mark.cuda
@pytest.mark.parametrize("b,hq,hkv,sq,skv,d,causal", [
    (1, 16, 8, 4096, 4096, 64, True),
    (1, 32, 8, 4096, 4096, 128, True),
    (2, 6, 6, 224, 1280, 64, False)])
def test_cuda_pair_keeps_the_split_precision(cuda_device, b, hq, hkv, sq,
                                             skv, d, causal):
    q, k, v, do = _card_qkv(cuda_device, b, hq, hkv, sq, skv, d, seed=2)
    scale = d ** -0.5
    _, o32, lse = train._forward_kernel(q, k, v, causal, scale)
    want_o32 = train.forward_plain(q, k, v, causal=causal, scale=scale)[1]
    assert _normgap(o32, want_o32) <= _SPLIT_O32_TOL
    del want_o32
    got = train._backward_kernel(q, k, v, o32, lse, do, causal, scale)
    want = train.backward_plain(q, k, v, o32, lse, do, causal=causal,
                                scale=scale)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert _normgap(g, w) <= _SPLIT_GRAD_TOL, name


@pytest.mark.cuda
def test_cuda_backward_is_deterministic(cuda_device):
    """No atomics: a second backward gives the same bits."""
    q, k, v, do = _card_qkv(cuda_device, 2, 16, 8, 2048, 2048, 64)
    first = _through(lambda *x: ops.attention(*x), q, k, v, do)
    second = _through(lambda *x: ops.attention(*x), q, k, v, do)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_cuda_chunked_calls_are_counted(cuda_device):
    """In a recording, a call on the card that qualifies counts as
    ``attn.fused`` and one that does not (f32) as ``attn.chunked``."""
    q, k, v, _ = _card_qkv(cuda_device, 1, 8, 2, 128, 128, 64)
    with obs.recording() as rec:
        ops.attention(q, k, v)
        ops.attention(q.float(), k.float(), v.float())
    assert rec.counters == {"attn.fused": 1, "attn.chunked": 1}


@pytest.mark.cuda
def test_cuda_replica_backward_runs_the_kernels(cuda_device):
    """``_Replica`` hands the replica's result a zero gradient; its
    backward runs through the kernels and gives zero gradients."""
    q, k, v, do = _card_qkv(cuda_device, 1, 8, 2, 256, 256, 64)
    kept = [x.clone().requires_grad_() for x in (q, k, v)]
    replica = [x.clone().requires_grad_() for x in (q, k, v)]
    out = attention._Replica.apply(ops.attention(*kept),
                                   ops.attention(*replica))
    before = dict(train.flash_attention_train.launches_by_kernel)
    out.backward(do)
    after = train.flash_attention_train.launches_by_kernel
    assert {n: after[n] - before[n] for n in train.KERNELS[1:]} \
        == dict.fromkeys(train.KERNELS[1:], 2)
    for x in replica:
        assert x.grad is not None and not bool(x.grad.any())
    want = _through(lambda *x: ops.attention(*x), q, k, v, do)[1:]
    for x, w in zip(kept, want):
        assert torch.equal(x.grad, w)
