"""The arithmetic of repro_torch's tensor-core kernels, modelled in torch on
the CPU and held against the JAX package's Pallas kernels.

The CUDA kernels run only on the card (``tests/test_torch_cuda.py``); what
they compute differently from their plain versions is modelled here, step
for step, so that the rounding they add is held to the reference's
tolerances without a card:

* ``flash_attention`` in bf16 (``csrc/flash_attention.cu``, the wgmma
  kernel): bf16 q and k, f32 scores, an online softmax over 64-key tiles
  in log2 units, P rounded to bf16 before P.V, f32 accumulation, row sums
  from the unrounded P, output rounded to bf16.  Held against
  ``flash_attention_pallas`` in interpret mode at 2e-2.
* ``tile_update_batched`` (``csrc/matmul.cu``, 3xTF32): each operand split
  into tf32 hi and lo parts, ``a_lo b_hi^T + a_hi b_lo^T + a_hi b_hi^T``
  in f32, subtracted from c.  Held against ``tile_update_pallas`` in
  interpret mode at 1e-4, where one tf32 product alone misses.
* ``matmul_batched`` (the same kernel body, b in its (K, N) layout): the
  3xTF32 product accumulated from zero, then added to c.  Held against
  ``matmul_pallas`` in interpret mode at 1e-4, where plain TF32 misses.
* ``flash_decode`` (``csrc/flash_decode.cu``, S split across a cluster):
  each warp's online softmax over its 8-key chunks of its block's range,
  the warps' partials merged into the block's and the blocks' into the
  cluster's by the log-sum-exp rule, with the kernel's ranges (short and
  empty ones included).  Held against ``flash_decode_pallas`` in
  interpret mode at 2e-5.

The models live here, not on any path.  Also here: the build's library
name follows the shared headers, the SASS counter's and the compiler
report's parsing, and the flash-attention wrapper's choice of kernel by
dtype.
"""
import math
import shutil
import subprocess

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.flash_attention import kernel as ref_fa_kernel
from repro.kernels.flash_decode import kernel as ref_fd_kernel
from repro.kernels.matmul import kernel as ref_mm_kernel
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.flash_decode import kernel as fd_kernel

_KEY_TILE = 64          # keys per tile of the bf16 kernel
_MASKED = -1e30


def _randn(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


# ---------------------------------------------------------------------------
# bf16 flash attention
def bf16_kernel_model(q, k, v, *, causal=True, bq=256, bk=256):
    """What the bf16 wgmma kernel computes, in torch: q, k, v bf16
    (B, H, S, D) -> bf16.  The masks are the plain version's three levels
    (score, -1e30, left out)."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    bq, bk = min(bq, sq), min(bk, skv)
    k = torch.repeat_interleave(k, hq // hkv, dim=1)
    v = torch.repeat_interleave(v, hq // hkv, dim=1)
    # bf16 products are exact in f32; the sum is f32
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * \
        (d ** -0.5 * math.log2(math.e))
    if causal:
        kv_off = skv - sq
        rows = torch.arange(sq)
        kpos = torch.arange(skv)[None, :]
        visible = kpos <= rows[:, None] + kv_off
        last_q = (rows // bq) * bq + bq - 1 + kv_off
        ran_to = torch.where(
            last_q >= 0,
            torch.clamp((last_q.clamp(min=0) // bk + 1) * bk, max=skv),
            torch.zeros_like(last_q))
        ran = kpos < ran_to[:, None]
        s.masked_fill_(ran & ~visible, _MASKED)
        s.masked_fill_(~ran, -torch.inf)
    m = torch.full((b, hq, sq, 1), _MASKED)
    l = torch.zeros((b, hq, sq, 1))
    acc = torch.zeros((b, hq, sq, d))
    for k0 in range(0, skv, _KEY_TILE):
        st = s[..., k0:k0 + _KEY_TILE]
        m_new = torch.maximum(m, st.amax(-1, keepdim=True))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(st - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + torch.einsum(
            "bhqk,bhkd->bhqd", p.to(torch.bfloat16).float(),
            v[:, :, k0:k0 + _KEY_TILE].float())
        m = m_new
    return (acc / torch.where(l == 0, torch.ones_like(l), l)).to(
        torch.bfloat16)


def _bf16_qkv(seed, b, hq, hkv, sq, skv, d):
    rng = np.random.default_rng(seed)
    xs = (_randn(rng, b, hq, sq, d), _randn(rng, b, hkv, skv, d),
          _randn(rng, b, hkv, skv, d))
    return (tuple(jnp.asarray(x, jnp.bfloat16) for x in xs),
            tuple(torch.from_numpy(x).to(torch.bfloat16) for x in xs))


@pytest.mark.parametrize("b,hq,hkv,sq,skv,d,causal,bq,bk", [
    # the grid of test_flash_attention_plain_matches_pallas
    (2, 4, 4, 128, 128, 64, True, 256, 256),
    (2, 4, 4, 128, 128, 64, False, 256, 256),
    (2, 8, 2, 128, 128, 64, True, 256, 256),
    (2, 8, 2, 128, 128, 64, False, 256, 256),
    # its corners
    (1, 2, 2, 32, 128, 32, True, 256, 256),     # prefill continuation
    (1, 2, 2, 64, 48, 32, True, 32, 16),        # rows seeing no key
    (1, 2, 2, 64, 48, 32, True, 16, 16),        # ... their block ran none
    (1, 12, 2, 64, 64, 32, True, 32, 32),       # group 6, small blocks
    (1, 4, 2, 96, 40, 128, True, 16, 8),        # no key at D 128
    (1, 6, 1, 50, 70, 128, True, 256, 256),     # group 6, ragged, D 128
    (1, 8, 2, 192, 192, 128, True, 64, 64),     # several key tiles
])
def test_bf16_kernel_model_matches_pallas(b, hq, hkv, sq, skv, d, causal,
                                          bq, bk):
    """Rounding P to bf16 (and the tiled, log2-unit softmax) stays inside
    the bf16 tolerance of the reference, 2e-2."""
    (jq, jk, jv), (tq, tk, tv) = _bf16_qkv(21, b, hq, hkv, sq, skv, d)
    want = np.asarray(ref_fa_kernel.flash_attention_pallas(
        jq, jk, jv, causal=causal, bq=bq, bk=bk, interpret=True),
        np.float32)
    got = bf16_kernel_model(tq, tk, tv, causal=causal, bq=bq, bk=bk)
    assert got.dtype == torch.bfloat16 and not torch.isnan(got).any()
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2e-2,
                               atol=2e-2)


def test_bf16_kernel_model_error_is_within_its_estimate():
    """Against the plain version on the same bf16 inputs, the model moves
    the f32 output by at most 2^-9 of max |v| (P's rounding), before the
    final rounding to bf16 adds half an ulp of the output."""
    _, (tq, tk, tv) = _bf16_qkv(22, 1, 8, 2, 256, 256, 128)
    got = bf16_kernel_model(tq, tk, tv).float()
    want = fa_kernel.flash_attention_plain(tq.float(), tk.float(),
                                           tv.float())
    bound = 2 ** -9 * tv.float().abs().max() + 2 ** -9 * want.abs()
    assert bool(((got - want).abs() <= bound + 1e-6).all())


def test_flash_attention_dispatches_by_dtype():
    """bf16 goes to the wgmma kernel, f32 to the FFMA one; nothing else is
    taken, and the per-kernel counts start at 0 for both."""
    assert fa_kernel.KERNELS == {
        torch.bfloat16: ("bf16_wgmma", "bddt_flash_attention_bf16"),
        torch.float32: ("f32_ffma", "bddt_flash_attention_f32")}
    assert set(fa_kernel.flash_attention.launches_by_kernel) == {
        "bf16_wgmma", "f32_ffma"}
    y = torch.zeros(1, 2, 16, 32, dtype=torch.bfloat16)
    before = dict(fa_kernel.flash_attention.launches_by_kernel)
    fa_kernel.flash_attention(y, y, y)         # the plain version: no count
    assert fa_kernel.flash_attention.launches_by_kernel == before


# ---------------------------------------------------------------------------
# 3xTF32 tile update
def tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 rounded to tf32's 10 mantissa bits, to nearest with ties away
    from zero (``cvt.rna.tf32.f32``)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tile_update_3xtf32_model(c, a, b, terms=3):
    """``c - a b^T`` as the kernel computes it: the small terms first, each
    product exact in f32 (tf32 x tf32 fits 24 bits), sums in f32.
    ``terms=1`` is plain TF32, ``a_hi b_hi^T`` alone."""
    a_hi, b_hi = tf32(a), tf32(b)
    a_lo, b_lo = tf32(a - a_hi), tf32(b - b_hi)
    prod = a_hi @ b_hi.mT
    if terms == 3:
        prod = (a_lo @ b_hi.mT + a_hi @ b_lo.mT) + prod
    return c - prod


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -12, -1.0 - 2 ** -11,
                      1.0 + 2 ** -12])
    got = tf32(x)
    assert got[0] == 1.0
    assert got[1] == 1.0 + 2 ** -10            # a tie rounds away from zero
    assert got[2] == 1.0 + 2 ** -10
    assert got[3] == -1.0 - 2 ** -10
    assert got[4] == 1.0                       # below half an ulp
    r = torch.randn(1000, generator=torch.Generator().manual_seed(0))
    assert ((tf32(r) - r).abs() <= r.abs() * 2 ** -11).all()
    assert (tf32(r).view(torch.int32) & 0x1FFF == 0).all()


@pytest.mark.parametrize("n,m,k,nn", [(8, 128, 128, 128), (5, 33, 70, 65)])
def test_3xtf32_model_matches_pallas(n, m, k, nn):
    """3xTF32 holds the reference's 1e-4 at the Cholesky app's tile shape
    and at an odd one; plain TF32 misses it at K 128."""
    rng = np.random.default_rng(23)
    c, a, b = (_randn(rng, *s) for s in ((n, m, nn), (n, m, k), (n, nn, k)))
    tc, ta, tb = (torch.from_numpy(x) for x in (c, a, b))
    got = tile_update_3xtf32_model(tc, ta, tb)
    one = tile_update_3xtf32_model(tc, ta, tb, terms=1)
    want = np.stack([np.asarray(ref_mm_kernel.tile_update_pallas(
        jnp.asarray(c[t]), jnp.asarray(a[t]), jnp.asarray(b[t]),
        interpret=True)) for t in range(n)])
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    if k >= 128:
        assert not np.allclose(one.numpy(), want, rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# 3xTF32 GEMM
def gemm_3xtf32_model(a, b, c, terms=3):
    """``c + a b`` as the GEMM kernel computes it: b in its (K, N) layout,
    the product accumulated from zero (the small terms first, each exact in
    f32), then added to c.  ``terms=1`` is plain TF32."""
    a_hi, b_hi = tf32(a), tf32(b)
    a_lo, b_lo = tf32(a - a_hi), tf32(b - b_hi)
    prod = a_hi @ b_hi
    if terms == 3:
        prod = (a_lo @ b_hi + a_hi @ b_lo) + prod
    return c + prod


@pytest.mark.parametrize("n,m,k,nn", [(16, 64, 64, 64), (5, 33, 70, 65)])
def test_gemm_3xtf32_model_matches_pallas(n, m, k, nn):
    """3xTF32 with b read as (K, N) holds the reference's 1e-4 at the
    matmul app's 64^3 tiles and at an odd shape; plain TF32 misses it at
    both (K 64 and 70)."""
    rng = np.random.default_rng(24)
    a, b, c = (_randn(rng, *s) for s in ((n, m, k), (n, k, nn), (n, m, nn)))
    ta, tb, tc = (torch.from_numpy(x) for x in (a, b, c))
    got = gemm_3xtf32_model(ta, tb, tc)
    one = gemm_3xtf32_model(ta, tb, tc, terms=1)
    want = np.stack([np.asarray(ref_mm_kernel.matmul_pallas(
        jnp.asarray(a[t]), jnp.asarray(b[t]), jnp.asarray(c[t]),
        interpret=True)) for t in range(n)])
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    assert not np.allclose(one.numpy(), want, rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# flash decode split across a cluster
def _merge(parts):
    """The log-sum-exp merge of unnormalised partials ``(m, l, acc)``,
    leaving out the parts that saw no key (``m = -inf``)."""
    big = torch.stack([m for m, _, _ in parts]).amax(0)
    lsum = torch.zeros_like(big)
    num = torch.zeros_like(parts[0][2])
    for m, l, acc in parts:
        e = torch.where(m == -torch.inf, torch.zeros_like(m),
                        torch.exp(m - big))
        lsum = lsum + l * e
        num = num + acc * e[..., None]
    return big, lsum, num


def split_decode_model(q, k, v, scale):
    """``(o, lse)`` as the cluster kernel computes them: block r of the
    cluster takes its range of keys (``fd_kernel.split``), warp w of the
    block its 8 keys of every 32-key stage of that range with its own
    online softmax, then the warps merge into the block and the blocks
    into the cluster."""
    b, hq, d = q.shape
    hkv, s = k.shape[1], k.shape[2]
    g = hq // hkv
    cs, rng = fd_kernel.split(s)
    kb, kw = fd_kernel.KEYS_PER_STAGE, fd_kernel.WARP_KEYS
    qg = q.reshape(b, hkv, g, d)
    blocks = []
    for r in range(cs):
        lo, hi = min(s, r * rng), min(s, r * rng + rng)
        warps = []
        for w in range(kb // kw):
            m = torch.full((b, hkv, g), -torch.inf)
            l = torch.zeros((b, hkv, g))
            acc = torch.zeros((b, hkv, g, d))
            for key0 in range(lo + w * kw, hi, kb):
                kc = k[:, :, key0:min(key0 + kw, hi)]
                vc = v[:, :, key0:min(key0 + kw, hi)]
                sc = torch.einsum("bhgd,bhtd->bhgt", qg, kc) * scale
                m_new = torch.maximum(m, sc.amax(-1))
                alpha = torch.exp(m - m_new)
                p = torch.exp(sc - m_new[..., None])
                l = l * alpha + p.sum(-1)
                acc = acc * alpha[..., None] + torch.einsum(
                    "bhgt,bhtd->bhgd", p, vc)
                m = m_new
            warps.append((m, l, acc))
        blocks.append(_merge(warps))
    big, lsum, num = _merge(blocks)
    safe = torch.where(lsum == 0, torch.ones_like(lsum), lsum)
    o = torch.where(lsum[..., None] == 0, torch.zeros_like(num),
                    num / safe[..., None])
    lse = torch.where(lsum == 0, torch.full_like(lsum, -1e30),
                      big + torch.log(safe))
    return o.reshape(b, hq, d), lse.reshape(b, hq)


def test_split_ranges():
    """A block's range is whole 32-key stages; short and empty ranges
    occur."""
    assert fd_kernel.split(512) == (16, 32)        # the serve path's tile
    assert fd_kernel.split(32768) == (16, 2048)    # the decode width's S
    for s in (1, 33, 200, 512):
        assert fd_kernel.split(s) == (16, 32)
    assert fd_kernel.split(513) == (16, 64)


@pytest.mark.parametrize("b,hq,hkv,s,d,bk,empty", [
    (1, 1, 1, 512, 128, 512, 0),   # the serve path's per-task shape
    (1, 1, 1, 200, 128, 200, 9),   # a short last range and empty ones
    (3, 6, 2, 77, 64, 77, 13),     # G = 3, ragged S
    (1, 1, 1, 1, 128, 1, 15),      # S = 1 (bk = S): fifteen empty blocks
    (2, 16, 2, 33, 32, 33, 14),    # G = 8, fewer keys than blocks
    (1, 4, 1, 1000, 64, 200, 0),   # G = 4, two stages a block, ragged
])
def test_split_decode_model_matches_pallas(b, hq, hkv, s, d, bk, empty):
    cs, rng = fd_kernel.split(s)
    assert sum(r * rng >= s for r in range(cs)) == empty
    rs = np.random.default_rng(25)
    q, k, v = (_randn(rs, *sh) for sh in ((b, hq, d), (b, hkv, s, d),
                                          (b, hkv, s, d)))
    want_o, want_lse = ref_fd_kernel.flash_decode_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), bk=bk,
        interpret=True)
    o, lse = split_decode_model(*(torch.from_numpy(x) for x in (q, k, v)),
                                d ** -0.5)
    np.testing.assert_allclose(o.numpy(), np.asarray(want_o), rtol=2e-5,
                               atol=2e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), rtol=2e-5,
                               atol=2e-5)


# ---------------------------------------------------------------------------
# the build: library names and SASS counts
def test_library_name_follows_the_shared_headers(tmp_path):
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    assert list(csrc.glob("*.cuh")), "the kernels share a header"
    names = {s: _build._target(s, csrc) for s in _build.SOURCES}
    assert names == {s: _build._target(s) for s in _build.SOURCES}
    header = next(csrc.glob("*.cuh"))
    header.write_text(header.read_text() + "\n// edited\n")
    changed = {s: _build._target(s, csrc) for s in _build.SOURCES}
    assert all(changed[s] != names[s] for s in _build.SOURCES)
    (csrc / "extra.cuh").write_text("#pragma once\n")
    assert _build._target("matmul", csrc) != changed["matmul"]
    # a source's own edit renames only its library
    src = csrc / "jacobi.cu"
    src.write_text(src.read_text() + "\n")
    assert _build._target("jacobi", csrc) != _build._target("jacobi")
    assert _build._target("matmul", csrc) == _build._target("matmul", csrc)


_DUMP = """
\tcode for sm_90a
\t\tFunction : _ZN4anon27flash_attention_bf16_kernelILi64EEEv
\t/*0000*/                   UTMALDG.3D [UR8], [UR4] ;
\t/*0010*/                   HGMMA.64x64x16.F32.BF16 R24, gdesc[UR4], RZ ;
\t/*0020*/                   HGMMA.64x64x16.F32.BF16 R24, gdesc[UR8], R24 ;
\t\tFunction : _ZN4anon26flash_attention_f32_kernelILi64EEEv
\t/*0000*/                   FFMA R1, R2, R3, R1 ;
\t/*0010*/                   UTMALDG.3D [UR8], [UR4] ;
\t\tFunction : _ZN4anon21attn_train_fwd_kernelILi64EEEv
\t/*0000*/                   UTMALDG.3D [UR8], [UR4] ;
\t/*0010*/                   HGMMA.64x64x16.F32.BF16 R24, gdesc[UR4], RZ ;
\t\tFunction : _ZN4anon20attn_train_dq_kernelILi64EEEv
\t/*0000*/                   UTMALDG.3D [UR8], [UR4] ;
\t/*0010*/                   UTMALDG.3D [UR8], [UR4] ;
\t/*0020*/                   HGMMA.64x64x16.F32.BF16 R24, gdesc[UR4], RZ ;
\t\tFunction : _ZN4anon22attn_train_dkdv_kernelILi64EEEv
\t/*0000*/                   HGMMA.64x64x16.F32.BF16 R24, gdesc[UR4], RZ ;
\t/*0010*/                   HGMMA.64x64x16.F32.BF16 R24, gdesc[UR8], R24 ;
\t/*0020*/                   HGMMA.64x64x16.F32.BF16 R24, gdesc[UR8], R24 ;
\t/*0030*/                   UTMALDG.3D [UR8], [UR4] ;
\t\tFunction : _ZN4anon25tile_update_3xtf32_kernelILb1EEEv
\t/*0000*/                   HMMA.1688.F32.TF32 R4, R8, R12, R4 ;
\t/*0010*/                   HMMA.16816.F32.BF16 R4, R8, R12, R4 ;
\t\tFunction : _ZN4anon23tile_gemm_3xtf32_kernelILi64ELb1EEEv
\t/*0000*/                   HMMA.1688.F32.TF32 R4, R8, R12, R4 ;
\t/*0010*/                   HMMA.1688.F32.TF32 R8, R8, R12, R8 ;
\t/*0020*/                   FFMA R1, R2, R3, R1 ;
"""


@pytest.mark.parametrize("source", sorted(_build.TENSOR_CORE_SASS))
def test_sass_counts_reads_only_the_named_kernel(monkeypatch, source):
    monkeypatch.setattr(_build, "build_all",
                        lambda names: {n: _build.BUILD_DIR / f"{n}.so"
                                       for n in names})
    monkeypatch.setattr(_build, "_cuobjdump", lambda: "cuobjdump")
    monkeypatch.setattr(subprocess, "run", lambda *a, **kw:
                        subprocess.CompletedProcess(a, 0, stdout=_DUMP))
    want = {"flash_attention_bf16_kernel": {"HGMMA": 2, "UTMALDG": 1},
            "attn_train_fwd_kernel": {"HGMMA": 1, "UTMALDG": 1},
            "attn_train_dq_kernel": {"HGMMA": 1, "UTMALDG": 2},
            "attn_train_dkdv_kernel": {"HGMMA": 3, "UTMALDG": 1},
            "tile_update_3xtf32_kernel": {"HMMA.TF32": 1},
            "tile_gemm_3xtf32_kernel": {"HMMA.TF32": 2}}
    kernels = _build.TENSOR_CORE_SASS[source]
    assert kernels and set(kernels) <= set(want)
    for function, patterns in kernels.items():
        assert _build.sass_counts(source, function, patterns) == \
            want[function]
        with pytest.raises(RuntimeError, match="no kernel"):
            _build.sass_counts(source, "no_such_kernel", patterns)


_PTXAS_LOG = """ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN4anon23tile_gemm_3xtf32_kernelILi64ELb1EEEv' for 'sm_90a'
ptxas info    : Function properties for _ZN4anon23tile_gemm_3xtf32_kernelILi64ELb1EEEv
    0 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 126 registers, used 1 barriers, 380 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN4anon25tile_update_3xtf32_kernelILb1EEEv' for 'sm_90a'
ptxas info    : Function properties for _ZN4anon25tile_update_3xtf32_kernelILb1EEEv
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 121 registers, 1024 bytes smem, 380 bytes cmem[0]
"""


def test_ptxas_report_reads_only_the_named_kernel(monkeypatch, tmp_path):
    lib = tmp_path / "matmul-0.so"
    lib.with_suffix(".log").write_text(_PTXAS_LOG)
    monkeypatch.setattr(_build, "build_all", lambda names: {
        n: lib for n in names})
    assert _build.ptxas_report("matmul", "tile_gemm_3xtf32_kernel") == {
        "_ZN4anon23tile_gemm_3xtf32_kernelILi64ELb1EEEv": dict(
            registers=126, spill_stores=8, spill_loads=4, smem=0)}
    assert _build.ptxas_report("matmul", "tile_update") == {
        "_ZN4anon25tile_update_3xtf32_kernelILb1EEEv": dict(
            registers=121, spill_stores=0, spill_loads=0, smem=1024)}
    with pytest.raises(RuntimeError, match="no kernel"):
        _build.ptxas_report("matmul", "no_such_kernel")
