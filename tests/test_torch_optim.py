"""repro_torch's optimizer, schedule, gradient compression, data pipeline
and chunked losses against the JAX package's, on the CPU.

Both packages get the same numpy trees.  Tolerances, each with its
reason:

* elementwise f32 arithmetic (the schedule, the clip's scaling, AdamW's
  mu, nu and parameters, the int8 scales and residuals): within 2 ulp.
  Both run the reference's operations in its order, one rounding each
  (the reference runs eagerly, op by op, so XLA contracts no FMA); the
  2 ulp cover ``cos`` and ``pow`` (the bias corrections), whose
  libraries may differ by an ulp.
* int8 values: bit-equal (``torch.round`` and ``jnp.round`` both round
  half to even).
* the global norm: 1e-6 relative; its per-leaf sums of squares reduce
  in another order in each framework.
* the chunked losses and attention (forward and gradients): 1e-5
  relative, and 1e-5 + 1e-4 * max|g| for gradients; the two frameworks
  sum the softmax and the products in other orders.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import SyntheticTokens as RefTokens
from repro.kernels.flash_attention import ops as ref_fa_ops
from repro.models import layers as ref_layers
from repro.optim import adamw as ref_adamw
from repro.optim import compress as ref_compress
from repro.optim import schedule as ref_schedule
from repro_torch import optim
from repro_torch.data import SyntheticTokens
from repro_torch.interop import opt_state_from_reference, opt_state_to_numpy
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.models import layers
from repro_torch.models.transformer import tree_leaves, tree_map
from repro_torch.optim import adamw, compress, schedule


def _tree(seed, scale=1.0):
    """A parameter-like tree, as the models have: stacked matrices and
    biases, a stacked norm scale (L, d), a table and a vector."""
    rng = np.random.default_rng(seed)

    def r(*shape):
        return (rng.standard_normal(shape) * scale).astype(np.float32)
    return {"blocks": {"attn": {"wq": {"w": r(2, 16, 24), "b": r(2, 24)}},
                       "ln1": {"scale": r(2, 16)}},
            "embed": {"table": r(40, 16)},
            "final_norm": {"scale": r(16)}}


def _torch(t):
    return tree_map(lambda a: torch.from_numpy(np.array(a)), t)


def _jax(t):
    return jax.tree_util.tree_map(jnp.asarray, t)


def _ulp(got, want, what, maxulp=2):
    for g, w in zip(tree_leaves(got), jax.tree_util.tree_leaves(want)):
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        np.testing.assert_array_max_ulp(g, np.asarray(w), maxulp=maxulp)


# ---------------------------------------------------------------------------
# schedule
@pytest.mark.parametrize("warmup,total", [(100, 10_000), (0, 60), (10, 10)])
def test_cosine_schedule_matches_reference(warmup, total):
    steps = [0, 1, 5, 9, 10, 11, 50, 99, 100, 101, 500, 5_000, 9_999,
             10_000, 12_000]
    kw = dict(peak_lr=3e-4, warmup_steps=warmup, total_steps=total)
    got = torch.stack([schedule.cosine_schedule(s, **kw) for s in steps])
    want = np.array([ref_schedule.cosine_schedule(s, **kw) for s in steps])
    assert got.dtype == torch.float32
    np.testing.assert_array_max_ulp(got.numpy(), want, maxulp=2)
    # a tensor step gives the same as an int step
    t = schedule.cosine_schedule(torch.tensor(7, dtype=torch.int32), **kw)
    assert torch.equal(t, schedule.cosine_schedule(7, **kw))


# ---------------------------------------------------------------------------
# clip and AdamW
@pytest.mark.parametrize("max_norm", [1.0, 1e3])
def test_clip_by_global_norm_matches_reference(max_norm):
    g = _tree(1, scale=0.5)
    got, gnorm = optim.clip_by_global_norm(_torch(g), max_norm)
    want, ref_gnorm = ref_adamw.clip_by_global_norm(_jax(g), max_norm)
    np.testing.assert_allclose(gnorm.item(), float(ref_gnorm), rtol=1e-6)
    _ulp(got, want, "clipped")
    if max_norm > float(ref_gnorm):           # no clip: unchanged
        _ulp(got, g, "unclipped", maxulp=0)


def test_adamw_update_matches_reference_over_steps():
    params = _tree(2)
    p_port = _torch(params)
    st_port = optim.adamw_init(p_port)
    p_ref = _jax(params)
    st_ref = ref_adamw.adamw_init(p_ref)
    assert st_port.step.dtype == torch.int32 and int(st_port.step) == 0
    assert set(st_port.mu) == set(params) and set(st_port.nu) == set(params)
    for k in range(4):
        g = _tree(10 + k, scale=0.1 * (k + 1))
        lr = schedule.cosine_schedule(k + 1, peak_lr=1e-2, warmup_steps=2,
                                      total_steps=10)
        ref_lr = ref_schedule.cosine_schedule(k + 1, peak_lr=1e-2,
                                              warmup_steps=2, total_steps=10)
        p_port, st_port = optim.adamw_update(_torch(g), st_port, p_port,
                                             lr=lr, weight_decay=0.1)
        p_ref, st_ref = ref_adamw.adamw_update(_jax(g), st_ref, p_ref,
                                               lr=ref_lr, weight_decay=0.1)
        assert int(st_port.step) == int(st_ref.step) == k + 1
        _ulp(st_port.mu, st_ref.mu, f"mu {k}")
        _ulp(st_port.nu, st_ref.nu, f"nu {k}")
        _ulp(p_port, p_ref, f"params {k}")


def test_adamw_decays_matrices_only_and_updates_in_place():
    """Leaves of rank >= 2 (the stacked (L, d) norm scales among them)
    decay; a rank-1 leaf with a zero gradient stays as it was."""
    params = _torch(_tree(3))
    before = tree_map(torch.clone, params)
    zeros = tree_map(torch.zeros_like, params)
    state = optim.adamw_init(params)
    mu = state.mu["embed"]["table"]
    out, state = optim.adamw_update(zeros, state, params, lr=0.5,
                                    weight_decay=0.1)
    assert out is params and state.mu["embed"]["table"] is mu
    assert torch.equal(params["final_norm"]["scale"],
                       before["final_norm"]["scale"])
    for p, b in ((params["blocks"]["ln1"]["scale"],
                  before["blocks"]["ln1"]["scale"]),
                 (params["embed"]["table"], before["embed"]["table"])):
        torch.testing.assert_close(p, b - 0.5 * 0.1 * b, rtol=1e-6,
                                   atol=1e-7)


def test_opt_state_carries_across_and_back():
    params = _jax(_tree(4))
    st = ref_adamw.adamw_init(params)
    _, st = ref_adamw.adamw_update(_jax(_tree(5)), st, params, lr=1e-3)
    ref_np = jax.tree_util.tree_map(np.asarray, st)
    port = opt_state_from_reference(ref_np, device="cpu")
    assert port.step.dtype == torch.int32 and int(port.step) == 1
    back = opt_state_to_numpy(port)
    assert back.step.dtype == np.int32 and int(back.step) == 1
    _ulp(back.mu, ref_np.mu, "mu", maxulp=0)
    _ulp(back.nu, ref_np.nu, "nu", maxulp=0)


# ---------------------------------------------------------------------------
# int8 compression
def test_compress_int8_matches_reference():
    rng = np.random.default_rng(6)
    g = rng.standard_normal((64, 33)).astype(np.float32)
    q, s = compress.compress_int8(torch.from_numpy(g))
    rq, rs = ref_compress.compress_int8(jnp.asarray(g))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    np.testing.assert_array_max_ulp(s.numpy(), np.asarray(rs), maxulp=2)
    d = compress.decompress_int8(q, s)
    rd = ref_compress.decompress_int8(rq, rs)
    np.testing.assert_array_max_ulp(d.numpy(), np.asarray(rd), maxulp=2)
    assert compress.decompress_int8(q, s, torch.bfloat16).dtype == \
        torch.bfloat16
    zq, zs = compress.compress_int8(torch.zeros(5))
    assert torch.equal(zq, torch.zeros(5, dtype=torch.int8)) and \
        zs.item() > 0


def test_round_half_to_even_as_the_reference():
    g = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 3.5], np.float32)
    q, _ = compress.compress_int8(torch.from_numpy(g))
    rq, _ = ref_compress.compress_int8(jnp.asarray(g))
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    assert q.tolist() == [127, 0, 2, 2, 0, -2, 4]


def test_compress_with_feedback_matches_reference_over_steps():
    g0 = _tree(7, scale=0.01)
    ef = compress.ef_init(_torch(g0))
    ref_ef = ref_compress.ef_init(_jax(g0))
    for k in range(3):
        g = _tree(20 + k, scale=0.01)
        qs, ef = compress.compress_with_feedback(_torch(g), ef)
        rqs, ref_ef = ref_compress.compress_with_feedback(_jax(g), ref_ef)
        ref_pairs = jax.tree_util.tree_leaves(
            rqs, is_leaf=lambda x: isinstance(x, tuple))
        for (q, s), (rq, rs) in zip(tree_leaves(qs), ref_pairs):
            np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
            np.testing.assert_array_max_ulp(s.numpy(), np.asarray(rs),
                                            maxulp=2)
        _ulp(ef.residual, ref_ef.residual, f"residual {k}")


# ---------------------------------------------------------------------------
# the data pipeline
def test_synthetic_tokens_deterministic_in_range_and_skips_ahead():
    d = SyntheticTokens(vocab_size=512, seq_len=33, global_batch=8, seed=3)
    a = d.batch_at(5)["tokens"]
    assert a.dtype == torch.int32 and tuple(a.shape) == (8, 33)
    assert int(a.min()) >= 0 and int(a.max()) < 512
    assert torch.equal(a, d.batch_at(5)["tokens"])
    assert not torch.equal(a, d.batch_at(6)["tokens"])
    assert not torch.equal(a, SyntheticTokens(512, 33, 8, seed=4)
                           .batch_at(5)["tokens"])
    it = d.stream(4)
    assert torch.equal(next(it)["tokens"], d.batch_at(4)["tokens"])
    assert torch.equal(next(it)["tokens"], a)


def test_synthetic_tokens_bigram_rule_and_host_slices():
    d = SyntheticTokens(vocab_size=100, seq_len=16, global_batch=8, seed=1)
    t = d.batch_at(2)["tokens"].long()
    shift = (t[:, 1::2] - t[:, ::2]) % 100
    assert bool(((shift >= 1) & (shift <= 16)).all())
    assert bool((shift == shift[:, :1]).all())     # one shift per row
    halves = [d.batch_at(2, host_index=h, host_count=2)["tokens"]
              for h in range(2)]
    assert all(tuple(h.shape) == (4, 16) for h in halves)
    assert not torch.equal(halves[0], halves[1])
    assert torch.equal(halves[1], d.batch_at(2, host_index=1,
                                             host_count=2)["tokens"])


def test_synthetic_tokens_distribution_is_the_references():
    """Other bits than threefry, the same law: the rank histogram of the
    even (Zipf) positions within sampling noise of the reference's."""
    kw = dict(vocab_size=64, seq_len=64, global_batch=64, seed=0)
    port = torch.cat([SyntheticTokens(**kw).batch_at(s)["tokens"][:, ::2]
                      for s in range(4)]).flatten().numpy()
    ref = np.concatenate([np.asarray(RefTokens(**kw).batch_at(s)["tokens"]
                                     )[:, ::2] for s in range(4)]).flatten()
    for r in (0, 1, 2, 10):
        assert abs((port == r).mean() - (ref == r).mean()) < 0.02, r


# ---------------------------------------------------------------------------
# the chunked loss and the chunked attention, values and gradients
@pytest.mark.parametrize("chunk", [16, 24, 1024])
def test_cross_entropy_loss_and_grads_match_reference(chunk):
    """chunk 16 splits S=64 into 4 checkpointed chunks; 24 does not
    divide 64, so one chunk, as the reference's rule says."""
    rng = np.random.default_rng(8)
    b, s, d, v = 2, 64, 32, 96
    h = rng.standard_normal((b, s, d)).astype(np.float32)
    w = (rng.standard_normal((d, v)) * 0.3).astype(np.float32)
    y = rng.integers(0, v, (b, s)).astype(np.int32)
    m = (rng.random((b, s)) > 0.2).astype(np.float32)

    ht, wt = torch.from_numpy(h).requires_grad_(), \
        torch.from_numpy(w).requires_grad_()
    loss = layers.cross_entropy_loss(lambda x: x @ wt, ht,
                                     torch.from_numpy(y),
                                     torch.from_numpy(m), chunk=chunk)
    loss.backward()

    def ref(hh, ww):
        return ref_layers.cross_entropy_loss(lambda x: x @ ww, hh,
                                             jnp.asarray(y), jnp.asarray(m),
                                             chunk=chunk)
    ref_loss, (gh, gw) = jax.value_and_grad(ref, argnums=(0, 1))(
        jnp.asarray(h), jnp.asarray(w))
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-5)
    for got, want in ((ht.grad, gh), (wt.grad, gw)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-5 + 1e-4 * np.abs(want).max())


@pytest.mark.parametrize("hq,hkv,sq,skv,qc,kc", [
    (4, 4, 64, 64, 16, 32), (4, 2, 64, 64, 64, 16), (4, 1, 32, 48, 16, 16)])
def test_chunked_attention_grads_match_reference_and_naive(hq, hkv, sq, skv,
                                                           qc, kc):
    rng = np.random.default_rng(9)
    q = rng.standard_normal((2, hq, sq, 32)).astype(np.float32)
    k = rng.standard_normal((2, hkv, skv, 32)).astype(np.float32)
    v = rng.standard_normal((2, hkv, skv, 32)).astype(np.float32)
    cot = rng.standard_normal((2, hq, sq, 32)).astype(np.float32)

    def port(impl):
        xs = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
        out = fa_ops.attention(*xs, impl=impl, q_chunk=qc, k_chunk=kc)
        (out * torch.from_numpy(cot)).sum().backward()
        return out.detach().numpy(), [x.grad.numpy() for x in xs]

    def ref(qq, kk, vv):
        out = ref_fa_ops.attention(qq, kk, vv, impl="chunked", q_chunk=qc,
                                   k_chunk=kc)
        return (out * jnp.asarray(cot)).sum(), out

    (_, ref_out), ref_grads = jax.value_and_grad(
        ref, argnums=(0, 1, 2), has_aux=True)(*map(jnp.asarray, (q, k, v)))
    out, grads = port("chunked")
    naive_out, naive_grads = port("naive")
    np.testing.assert_allclose(out, np.asarray(ref_out), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(out, naive_out, rtol=1e-5, atol=1e-5)
    for got, want, plain in zip(grads, ref_grads, naive_grads):
        tol = 1e-5 + 1e-4 * np.abs(plain).max()
        np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=tol)
        np.testing.assert_allclose(got, plain, rtol=0, atol=tol)


def test_pallas_attention_under_grad_raises_in_both_packages():
    q = np.ones((1, 2, 16, 32), np.float32)
    x = torch.from_numpy(q).requires_grad_()
    with pytest.raises(RuntimeError, match="no backward"):
        fa_ops.attention(x, x, x, impl="pallas")
    with pytest.raises(AssertionError):
        jax.grad(lambda a: ref_fa_ops.attention(
            a, a, a, impl="pallas", interpret=True).sum())(jnp.asarray(q))
    with torch.no_grad():                      # no grad: the plain version
        out = fa_ops.attention(x, x, x, impl="pallas")
    assert tuple(out.shape) == (1, 2, 16, 32)


def test_optim_exports_the_references_names():
    import repro.optim as ref_optim
    assert optim.__all__ == ref_optim.__all__
    assert adamw.AdamWState._fields == ref_adamw.AdamWState._fields
    assert compress.ErrorFeedbackState._fields == \
        ref_compress.ErrorFeedbackState._fields
