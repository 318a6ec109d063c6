"""repro_torch's wave kernels against the JAX package's Pallas kernels.

On the CPU each batched wrapper runs its plain PyTorch version; those are
held, task by task, against ``matmul_pallas`` / ``tile_update_pallas`` /
``jacobi_step_pallas`` run in interpret mode on the same numpy inputs, at
the reference's tolerances (1e-4 / 1e-4 / 1e-6, ``tests/test_kernels.py``).
The CUDA kernels themselves are held against these plain versions on the
card by ``tests/test_torch_cuda.py``.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.cholesky import ops as ref_chol_ops
from repro.kernels.jacobi import kernel as ref_jac_kernel
from repro.kernels.jacobi import ops as ref_jac_ops
from repro.kernels.matmul import kernel as ref_mm_kernel
from repro.kernels.matmul import ops as ref_mm_ops
from repro_torch.kernels.cholesky import ops as chol_ops
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
