"""repro_torch's kernels against the JAX package's Pallas kernels.

On the CPU each wrapper runs its plain PyTorch version; those are held
against ``matmul_pallas`` / ``tile_update_pallas`` / ``jacobi_step_pallas``
(task by task) and ``flash_decode_pallas`` / ``black_scholes_pallas`` run
in interpret mode on the same numpy inputs, at the reference's
tolerances (1e-4 / 1e-4 / 1e-6 / 2e-5 / rtol 1e-5 atol 1e-3,
``tests/test_kernels.py``).  The flash-decode and Black-Scholes
operators' vmap rules are held against the per-task loop.  The flash
attention plain version and the port's ``attention`` ops are held against
``flash_attention_pallas`` in interpret mode, ``chunked_attention`` and
the ``mha`` oracle against the reference's.
The CUDA kernels themselves are held against these plain versions on the
card by ``tests/test_torch_cuda.py``.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.black_scholes import ops as ref_bs_ops
from repro.kernels.cholesky import ops as ref_chol_ops
from repro.kernels.flash_attention import kernel as ref_fa_kernel
from repro.kernels.flash_attention import ops as ref_fa_ops
from repro.kernels.flash_attention import ref as ref_fa_ref
from repro.kernels.flash_decode import kernel as ref_fd_kernel
from repro.kernels.flash_decode import ops as ref_fd_ops
from repro.kernels.flash_decode import ref as ref_fd_ref
from repro.kernels.jacobi import kernel as ref_jac_kernel
from repro.kernels.jacobi import ops as ref_jac_ops
from repro.kernels.matmul import kernel as ref_mm_kernel
from repro.kernels.matmul import ops as ref_mm_ops
from repro_torch.kernels.black_scholes import kernel as bs_kernel
from repro_torch.kernels.black_scholes import ops as bs_ops
from repro_torch.kernels.cholesky import ops as chol_ops
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.kernels.flash_decode import kernel as fd_kernel
from repro_torch.kernels.flash_decode import ops as fd_ops
from repro_torch.kernels.jacobi import kernel as jac_kernel
from repro_torch.kernels.jacobi import ops as jac_ops
from repro_torch.kernels.matmul import kernel as mm_kernel
from repro_torch.kernels.matmul import ops as mm_ops


def _randn(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


# ---------------------------------------------------------------------------
# plain batched versions vs the Pallas kernels (interpret mode), per task
@pytest.mark.parametrize("n,m,k,nn", [(3, 32, 48, 40), (2, 64, 64, 64)])
def test_matmul_plain_matches_pallas(n, m, k, nn):
    rng = np.random.default_rng(0)
    a, b, c = _randn(rng, n, m, k), _randn(rng, n, k, nn), _randn(rng, n, m, nn)
    got = mm_kernel.matmul_batched(*(torch.from_numpy(x) for x in (a, b, c)))
    assert got.shape == (n, m, nn) and got.dtype == torch.float32
    for t in range(n):
        want = ref_mm_kernel.matmul_pallas(
            jnp.asarray(a[t]), jnp.asarray(b[t]), jnp.asarray(c[t]),
            interpret=True)
        np.testing.assert_allclose(got[t].numpy(), np.asarray(want),
                                   rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("n,m,k,nn", [(3, 32, 48, 40), (2, 64, 64, 64)])
def test_tile_update_plain_matches_pallas(n, m, k, nn):
    rng = np.random.default_rng(1)
    c, a, b = _randn(rng, n, m, nn), _randn(rng, n, m, k), _randn(rng, n, nn, k)
    got = mm_kernel.tile_update_batched(
        *(torch.from_numpy(x) for x in (c, a, b)))
    for t in range(n):
        want = ref_mm_kernel.tile_update_pallas(
            jnp.asarray(c[t]), jnp.asarray(a[t]), jnp.asarray(b[t]),
            interpret=True)
        np.testing.assert_allclose(got[t].numpy(), np.asarray(want),
                                   rtol=1e-4, atol=1e-4)


# the jacobi app's halo shapes at tile 16: corner, edge and interior
@pytest.mark.parametrize("h,w,offsets", [
    (32, 32, [(0, 0), (16, 16), (0, 16)]),
    (48, 32, [(16, 0), (16, 16)]),
    (48, 48, [(16, 16), (16, 16), (16, 16)]),
])
def test_jacobi_halo_plain_matches_pallas(h, w, offsets):
    rng = np.random.default_rng(2)
    n, tile = len(offsets), 16
    halo = _randn(rng, n, h, w)
    r0 = torch.tensor([o[0] for o in offsets])
    c0 = torch.tensor([o[1] for o in offsets])
    got = jac_kernel.jacobi_halo_batched(torch.from_numpy(halo), r0, c0,
                                         (tile, tile))
    assert got.shape == (n, tile, tile)
    for t, (i, j) in enumerate(offsets):
        full = np.asarray(ref_jac_kernel.jacobi_step_pallas(
            jnp.asarray(halo[t]), interpret=True))
        np.testing.assert_allclose(got[t].numpy(),
                                   full[i:i + tile, j:j + tile],
                                   rtol=1e-6, atol=1e-6)


def test_jacobi_halo_clamps_offsets_like_dynamic_slice():
    """Out-of-range starts clamp so the tile fits, as
    ``jax.lax.dynamic_slice`` does in the reference body."""
    halo = torch.arange(2 * 8 * 8, dtype=torch.float32).reshape(2, 8, 8)
    got = jac_kernel.jacobi_halo_batched(
        halo, torch.tensor([9, -3]), torch.tensor([-1, 7]), (4, 4))
    want = jac_kernel.jacobi_halo_batched(
        halo, torch.tensor([4, 0]), torch.tensor([0, 4]), (4, 4))
    assert torch.equal(got, want)


def test_cpu_wrappers_run_plain_versions_without_counting():
    rng = np.random.default_rng(3)
    a, b, c = (torch.from_numpy(_randn(rng, 2, 8, 8)) for _ in range(3))
    before = (mm_kernel.matmul_batched.launches,
              mm_kernel.tile_update_batched.launches,
              jac_kernel.jacobi_halo_batched.launches)
    assert torch.equal(mm_kernel.matmul_batched(a, b, c),
                       mm_kernel.matmul_batched_plain(a, b, c))
    assert torch.equal(mm_kernel.tile_update_batched(c, a, b),
                       mm_kernel.tile_update_batched_plain(c, a, b))
    zero = torch.zeros(2, dtype=torch.int64)
    assert torch.equal(
        jac_kernel.jacobi_halo_batched(a, zero, zero, (4, 4)),
        jac_kernel.jacobi_halo_batched_plain(a, zero, zero, (4, 4)))
    assert (mm_kernel.matmul_batched.launches,
            mm_kernel.tile_update_batched.launches,
            jac_kernel.jacobi_halo_batched.launches) == before


def test_ops_match_the_reference_ops():
    """The task bodies' plain entries against the JAX package's ops."""
    rng = np.random.default_rng(4)
    a, b, c = (_randn(rng, 16, 16) for _ in range(3))
    spd = a @ a.T + 16 * np.eye(16, dtype=np.float32)
    t = {k: torch.from_numpy(v) for k, v in
         dict(a=a, b=b, c=c, spd=spd).items()}
    j = {k: jnp.asarray(v) for k, v in dict(a=a, b=b, c=c, spd=spd).items()}
    pairs = [
        (mm_ops.matmul(t["a"], t["b"], t["c"]),
         ref_mm_ops.matmul(j["a"], j["b"], j["c"])),
        (mm_ops.tile_update(t["c"], t["a"], t["b"]),
         ref_mm_ops.tile_update(j["c"], j["a"], j["b"])),
        (chol_ops.update(t["c"], t["a"], t["b"]),
         ref_chol_ops.update(j["c"], j["a"], j["b"])),
        (chol_ops.potrf(t["spd"]), ref_chol_ops.potrf(j["spd"])),
        (chol_ops.trsm(chol_ops.potrf(t["spd"]), t["a"]),
         ref_chol_ops.trsm(ref_chol_ops.potrf(j["spd"]), j["a"])),
        (jac_ops.jacobi(t["a"], iters=3), ref_jac_ops.jacobi(j["a"], iters=3)),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-4, atol=1e-4)


def test_wrappers_raise_on_a_device_they_do_not_serve():
    """No silent fallback: a tensor that is neither on the CPU nor on a
    CUDA device is refused, not computed some other way."""
    meta = torch.empty(2, 8, 8, device="meta")
    idx = torch.empty(2, dtype=torch.int64, device="meta")
    with pytest.raises(ValueError):
        mm_kernel.matmul_batched(meta, meta, meta)
    with pytest.raises(ValueError):
        mm_kernel.tile_update_batched(meta, meta, meta)
    with pytest.raises(ValueError):
        jac_kernel.jacobi_halo_batched(meta, idx, idx, (4, 4))


# ---------------------------------------------------------------------------
# flash decode: the plain version (the CPU side of its operator) against
# flash_decode_pallas in interpret mode, and the decode-sharding contract
@pytest.mark.parametrize("hq,hkv,s", [(8, 2, 512), (4, 4, 256),
                                      (16, 8, 1024)])
def test_flash_decode_plain_matches_pallas(hq, hkv, s):
    rng = np.random.default_rng(5)
    b, d = 2, 64
    q, k, v = _randn(rng, b, hq, d), _randn(rng, b, hkv, s, d), \
        _randn(rng, b, hkv, s, d)
    o, lse = fd_ops.decode_partial(*(torch.from_numpy(x) for x in (q, k, v)),
                                   bk=128)
    want_o, want_lse = ref_fd_kernel.flash_decode_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), bk=128,
        interpret=True)
    assert o.shape == (b, hq, d) and lse.shape == (b, hq)
    np.testing.assert_allclose(o.numpy(), np.asarray(want_o),
                               rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse),
                               rtol=2e-5, atol=2e-5)
    got = fd_ops.decode_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                                  bk=128)
    want = ref_fd_ops.decode_attention(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), use_pallas=True,
                                       interpret=True, bk=128)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("hq,hkv,s", [(8, 2, 512), (4, 4, 256),
                                      (16, 8, 1024)])
def test_flash_decode_plain_matches_pallas_on_bf16_kv(hq, hkv, s):
    """K and V in bf16 (q in f32): the TPU kernel casts each K/V block to
    f32, the plain version upcasts; both round the same f32 inputs to
    bf16 the same way (to nearest even), so they agree at the f32
    tolerance.  On the CPU the wrapper takes bf16 K/V too."""
    rng = np.random.default_rng(8)
    b, d = 2, 64
    q, k, v = _randn(rng, b, hq, d), _randn(rng, b, hkv, s, d), \
        _randn(rng, b, hkv, s, d)
    tk, tv = (torch.from_numpy(x).to(torch.bfloat16) for x in (k, v))
    jk, jv = (jnp.asarray(x).astype(jnp.bfloat16) for x in (k, v))
    np.testing.assert_array_equal(tk.float().numpy(),
                                  np.asarray(jk.astype(jnp.float32)))
    o, lse = fd_ops.decode_partial(torch.from_numpy(q), tk, tv, bk=128)
    want_o, want_lse = ref_fd_kernel.flash_decode_pallas(
        jnp.asarray(q), jk, jv, bk=128, interpret=True)
    assert o.dtype == lse.dtype == torch.float32
    np.testing.assert_allclose(o.numpy(), np.asarray(want_o),
                               rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse),
                               rtol=2e-5, atol=2e-5)
    wo, wl = fd_kernel.flash_decode(torch.from_numpy(q), tk, tv, bk=128)
    assert torch.equal(wo, o) and torch.equal(wl, lse)


@pytest.mark.parametrize("n_shards", [1, 2, 4, 8])
def test_flash_decode_shard_combine_is_exact(n_shards):
    """LSE-combining partials over any sequence split equals the full
    attention of the reference's ``decode_mha``."""
    rng = np.random.default_rng(6)
    b, hq, hkv, s, d = 1, 4, 2, 256, 32
    q, k, v = _randn(rng, b, hq, d), _randn(rng, b, hkv, s, d), \
        _randn(rng, b, hkv, s, d)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    chunk = s // n_shards
    parts = [fd_ops.decode_partial(tq, tk[:, :, i * chunk:(i + 1) * chunk],
                                   tv[:, :, i * chunk:(i + 1) * chunk])
             for i in range(n_shards)]
    got = fd_ops.combine_partials(torch.stack([p[0] for p in parts]),
                                  torch.stack([p[1] for p in parts]))
    want = ref_fd_ref.decode_mha(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=2e-5, atol=2e-5)


def test_flash_decode_masked_padding_shard():
    """A shard that is entirely padding does not perturb the combine, and
    its partial is the reference's."""
    rng = np.random.default_rng(7)
    b, hq, hkv, s, d = 1, 4, 2, 128, 32
    q, k, v = _randn(rng, b, hq, d), _randn(rng, b, hkv, s, d), \
        _randn(rng, b, hkv, s, d)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    o1, l1 = fd_ops.decode_partial(tq, tk, tv)
    o2, l2 = fd_ops.decode_partial(tq, tk, tv,
                                   mask=torch.zeros((b, s), dtype=bool))
    got = fd_ops.combine_partials(torch.stack([o1, o2]),
                                  torch.stack([l1, l2]))
    want = ref_fd_ref.decode_mha(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=2e-5, atol=2e-5)
    r2 = ref_fd_ops.decode_partial(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v),
                                   mask=jnp.zeros((b, s), bool))
    np.testing.assert_allclose(o2.numpy(), np.asarray(r2[0]),
                               rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(l2.numpy(), np.asarray(r2[1]), rtol=2e-5)


def test_flash_decode_rejects_what_the_reference_rejects():
    q, k = torch.zeros(1, 2, 32), torch.zeros(1, 1, 96, 32)
    with pytest.raises(ValueError, match="not divisible"):
        fd_kernel.flash_decode(q, k, k, bk=64)        # 96 % 64
    with pytest.raises(ValueError, match="split"):
        fd_kernel.flash_decode(torch.zeros(1, 3, 32),
                               torch.zeros(1, 2, 64, 32),
                               torch.zeros(1, 2, 64, 32))
    meta = torch.empty(1, 1, 64, 32, device="meta")
    with pytest.raises(ValueError):
        fd_kernel.flash_decode(torch.empty(1, 1, 32, device="meta"),
                               meta, meta)


# ---------------------------------------------------------------------------
# Black-Scholes: the plain version (the CPU side of its operator) against
# black_scholes_pallas in interpret mode
def _options(rng, n):
    return [rng.uniform(10, 200, n).astype(np.float32),
            rng.uniform(10, 200, n).astype(np.float32),
            rng.uniform(0.1, 2.0, n).astype(np.float32),
            np.full(n, 0.03, np.float32),
            rng.uniform(0.1, 0.6, n).astype(np.float32)]


@pytest.mark.parametrize("n", [512, 2048, 1000, 129])
def test_black_scholes_plain_matches_pallas(n):
    cols = _options(np.random.default_rng(8), n)
    call, put = bs_ops.black_scholes(*(torch.from_numpy(c) for c in cols))
    want_c, want_p = ref_bs_ops.black_scholes(
        *(jnp.asarray(c) for c in cols), use_pallas=True, interpret=True,
        block_rows=4)
    assert call.shape == put.shape == (n,)
    np.testing.assert_allclose(call.numpy(), np.asarray(want_c),
                               rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(put.numpy(), np.asarray(want_p),
                               rtol=1e-5, atol=1e-3)


def test_black_scholes_put_call_parity():
    rng = np.random.default_rng(9)
    n = 256
    spot = torch.from_numpy(rng.uniform(50, 150, n).astype(np.float32))
    strike = torch.full((n,), 100.0)
    t = torch.full((n,), 1.0)
    rate = torch.full((n,), 0.05)
    vol = torch.full((n,), 0.3)
    call, put = bs_ops.black_scholes(spot, strike, t, rate, vol)
    parity = call - put - (spot - strike * torch.exp(-rate * t))
    np.testing.assert_allclose(parity.numpy(), 0.0, atol=1e-4)


# ---------------------------------------------------------------------------
# the operators' vmap rules: one wrapper call per group, equal to the loop
def _spy(monkeypatch, module, name):
    calls = []
    inner = getattr(module, name)

    def spy(*args):
        calls.append(tuple(args[0].shape))
        return inner(*args)

    monkeypatch.setattr(module, name, spy)
    return calls


def test_black_scholes_vmap_rule_equals_the_task_loop(monkeypatch):
    rng = np.random.default_rng(10)
    tasks = [_options(rng, 64) for _ in range(5)]
    cols = [torch.from_numpy(np.stack([t[j] for t in tasks]))
            for j in range(5)]                      # (5 tasks, 64 options)
    calls = _spy(monkeypatch, bs_kernel, "black_scholes_plain")
    call, put = torch.func.vmap(bs_ops.black_scholes)(*cols)
    assert calls == [(5, 64)]                       # one call per group
    for i in range(5):
        c, p = bs_ops.black_scholes(*(x[i] for x in cols))
        assert torch.equal(call[i], c) and torch.equal(put[i], p)
    # an unbatched operand broadcasts across the task axis
    call2, _ = torch.func.vmap(bs_ops.black_scholes,
                               in_dims=(0, 0, 0, None, 0))(
        cols[0], cols[1], cols[2], cols[3][0], cols[4])
    for i in range(5):
        c, _ = bs_ops.black_scholes(cols[0][i], cols[1][i], cols[2][i],
                                    cols[3][0], cols[4][i])
        assert torch.equal(call2[i], c)


def test_flash_decode_vmap_rule_equals_the_task_loop(monkeypatch):
    rng = np.random.default_rng(11)
    q = torch.from_numpy(_randn(rng, 6, 1, 4, 32))           # (T, B, Hq, D)
    k = torch.from_numpy(_randn(rng, 6, 1, 2, 64, 32))
    v = torch.from_numpy(_randn(rng, 6, 1, 2, 64, 32))
    calls = _spy(monkeypatch, fd_kernel, "flash_decode_plain")
    o, lse = torch.func.vmap(fd_ops.decode_partial)(q, k, v)
    assert calls == [(6, 4, 32)]                    # task axis folded in B
    assert o.shape == (6, 1, 4, 32) and lse.shape == (6, 1, 4)
    for i in range(6):
        oi, li = fd_ops.decode_partial(q[i], k[i], v[i])
        torch.testing.assert_close(o[i], oi, rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(lse[i], li, rtol=1e-6, atol=1e-6)
    # an unbatched query against batched shards
    o2, _ = torch.func.vmap(fd_ops.decode_partial, in_dims=(None, 0, 0))(
        q[0], k, v)
    for i in range(6):
        torch.testing.assert_close(o2[i], fd_ops.decode_partial(
            q[0], k[i], v[i])[0], rtol=1e-6, atol=1e-6)


def test_new_cpu_wrappers_run_plain_versions_without_counting():
    rng = np.random.default_rng(12)
    before = (fd_kernel.flash_decode.launches,
              bs_kernel.black_scholes.launches)
    q, k = torch.from_numpy(_randn(rng, 1, 2, 32)), \
        torch.from_numpy(_randn(rng, 1, 1, 64, 32))
    o, lse = fd_kernel.flash_decode(q, k, k)
    wo, wl = fd_kernel.flash_decode_plain(q, k, k, 32 ** -0.5)
    assert torch.equal(o, wo) and torch.equal(lse, wl)
    cols = [torch.from_numpy(c) for c in _options(rng, 33)]
    assert all(torch.equal(a, b) for a, b in zip(
        bs_kernel.black_scholes(*cols), bs_kernel.black_scholes_plain(*cols)))
    assert (fd_kernel.flash_decode.launches,
            bs_kernel.black_scholes.launches) == before
    with pytest.raises(ValueError, match="one shape"):
        bs_kernel.black_scholes(*cols[:4], cols[4][:5])


# ---------------------------------------------------------------------------
# flash attention: the plain version (what the wrapper runs on the CPU) and
# the port's attention ops against flash_attention_pallas in interpret mode
def _qkv(rng, b, hq, hkv, sq, skv, d, dtype=np.float32):
    """The same rounded inputs for both packages: numpy f32 drawn from the
    seed, cast to ``dtype`` (round to nearest even in both)."""
    xs = (_randn(rng, b, hq, sq, d), _randn(rng, b, hkv, skv, d),
          _randn(rng, b, hkv, skv, d))
    if dtype == np.float32:
        return xs, tuple(torch.from_numpy(x) for x in xs)
    return (tuple(jnp.asarray(x, jnp.bfloat16) for x in xs),
            tuple(torch.from_numpy(x).to(torch.bfloat16) for x in xs))


def _pallas(q, k, v, **kw):
    return np.asarray(ref_fa_kernel.flash_attention_pallas(
        *(jnp.asarray(x) for x in (q, k, v)), interpret=True, **kw),
        np.float32)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("hq,hkv", [(4, 4), (8, 2)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_plain_matches_pallas(causal, hq, hkv, dtype):
    """The reference's grid (``tests/test_kernels.py`` TestFlashAttention):
    B 2, S 128, D 64 at 2e-5 in f32 and 2e-2 in bf16."""
    rng = np.random.default_rng(13)
    dt = np.float32 if dtype == "float32" else jnp.bfloat16
    (jq, jk, jv), (tq, tk, tv) = _qkv(rng, 2, hq, hkv, 128, 128, 64, dt)
    want = _pallas(jq, jk, jv, causal=causal)
    tol = 2e-5 if dtype == "float32" else 2e-2
    got = fa_kernel.flash_attention(tq, tk, tv, causal=causal)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    via_ops = fa_ops.attention(tq, tk, tv, causal=causal, impl="pallas")
    for x in (got, via_ops):
        np.testing.assert_allclose(x.float().numpy(), want, rtol=tol,
                                   atol=tol)


@pytest.mark.parametrize("sq,skv,hq,hkv,bq,bk,tol", [
    (32, 128, 2, 2, 256, 256, 2e-5),   # prefill continuation, Sq < Skv
    (64, 48, 2, 2, 32, 16, 1e-6),      # rows seeing no key: V's mean
    (64, 48, 2, 2, 16, 16, 1e-6),      # ... or 0 where the block ran none
    (64, 64, 12, 2, 32, 32, 2e-5),     # group 6 (Nemotron-4-15B's ratio)
])
def test_flash_attention_plain_matches_pallas_corners(sq, skv, hq, hkv, bq,
                                                      bk, tol):
    rng = np.random.default_rng(14)
    (jq, jk, jv), (tq, tk, tv) = _qkv(rng, 1, hq, hkv, sq, skv, 32)
    want = _pallas(jq, jk, jv, causal=True, bq=bq, bk=bk)
    got = fa_kernel.flash_attention(tq, tk, tv, causal=True, bq=bq, bk=bk)
    np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol)
    if sq > skv:
        # the rows that see no key are what the reference kernel makes
        # of them, not the oracle's NaN
        assert np.isnan(np.asarray(ref_fa_ref.mha(jq, jk, jv))).any()
        assert not np.isnan(got.numpy()).any()


def test_flash_attention_rejects_what_the_reference_rejects():
    rng = np.random.default_rng(15)
    (jq, jk, jv), (tq, tk, tv) = _qkv(rng, 1, 2, 2, 96, 96, 32)
    with pytest.raises(ValueError, match="not divisible"):
        ref_fa_kernel.flash_attention_pallas(jq, jk, jv, bq=64,
                                             interpret=True)
    with pytest.raises(ValueError, match="not divisible"):
        fa_kernel.flash_attention(tq, tk, tv, bq=64)
    with pytest.raises(ValueError, match="not divisible"):
        fa_kernel.flash_attention_plain(tq, tk, tv, bk=64)
    with pytest.raises(ValueError, match="split"):
        fa_kernel.flash_attention(torch.zeros(1, 3, 8, 32),
                                  torch.zeros(1, 2, 8, 32),
                                  torch.zeros(1, 2, 8, 32))
    with pytest.raises(ValueError, match="unknown"):
        fa_ops.attention(tq, tk, tv, impl="flash")


def test_flash_attention_wrapper_refuses_grad_and_other_devices():
    """No backward, as the TPU kernel has none; no silent fallback from a
    device the kernel does not serve; no count for the plain version."""
    x = torch.zeros(1, 2, 16, 32, requires_grad=True)
    y = torch.zeros(1, 2, 16, 32)
    with pytest.raises(RuntimeError, match="no backward"):
        fa_kernel.flash_attention(x, y, y)
    with torch.no_grad():
        assert fa_kernel.flash_attention(x, y, y).shape == x.shape
    meta = torch.empty(1, 2, 16, 32, device="meta")
    with pytest.raises(ValueError, match="devices"):
        fa_kernel.flash_attention(meta, meta, meta)
    before = fa_kernel.flash_attention.launches
    assert torch.equal(fa_kernel.flash_attention(y, y, y),
                       fa_kernel.flash_attention_plain(y, y, y))
    assert fa_kernel.flash_attention.launches == before


@pytest.mark.parametrize("sq,skv,q_chunk,k_chunk,causal", [
    (128, 128, 32, 64, True),
    (64, 128, 32, 32, True),           # Sq < Skv
    (48, 48, 32, 32, True),            # odd lengths: one-chunk fallback
    (128, 128, 64, 32, False),
    (64, 48, 32, 16, True),            # rows seeing no key: V's mean
])
def test_chunked_attention_matches_reference(sq, skv, q_chunk, k_chunk,
                                             causal):
    rng = np.random.default_rng(16)
    (jq, jk, jv), (tq, tk, tv) = _qkv(rng, 2, 4, 2, sq, skv, 32)
    want = np.asarray(ref_fa_ops.chunked_attention(
        jq, jk, jv, causal=causal, q_chunk=q_chunk, k_chunk=k_chunk))
    got = fa_ops.chunked_attention(tq, tk, tv, causal=causal,
                                   q_chunk=q_chunk, k_chunk=k_chunk)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)
    via_ops = fa_ops.attention(tq, tk, tv, causal=causal, impl="chunked",
                               q_chunk=q_chunk, k_chunk=k_chunk)
    assert torch.equal(via_ops, got)


@pytest.mark.parametrize("sq,skv,causal", [(64, 64, True), (32, 64, True),
                                           (64, 64, False), (64, 48, True)])
def test_mha_oracle_matches_reference(sq, skv, causal):
    rng = np.random.default_rng(17)
    (jq, jk, jv), (tq, tk, tv) = _qkv(rng, 1, 8, 2, sq, skv, 32)
    want = np.asarray(ref_fa_ref.mha(jq, jk, jv, causal=causal))
    got = fa_ref.mha(tq, tk, tv, causal=causal).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    np.testing.assert_allclose(got[ok], want[ok], rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(
        fa_ops.attention(tq, tk, tv, causal=causal, impl="naive").numpy()[ok],
        want[ok], rtol=2e-5, atol=2e-5)
