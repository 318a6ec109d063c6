"""The port's tiled-Cholesky oracle (``kernels/cholesky/ref.py``'s
``cholesky_blocked``) against the reference's and against
``torch.linalg.cholesky``, on the same seeded SPD input, at the
reference's sizes and tolerance (``tests/test_kernels.py``'s
``TestCholesky``)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.cholesky import ref as jref
from repro_torch.kernels.cholesky import ref as tref

RTOL = ATOL = 2e-3


def _spd(n: int, seed: int) -> np.ndarray:
    a = np.random.default_rng(seed).standard_normal((n, n))
    return (a @ a.T + n * np.eye(n)).astype(np.float32)


@pytest.mark.parametrize("n,tile", [(256, 64), (384, 128)])
def test_cholesky_blocked_matches_the_reference_and_lapack(n, tile):
    spd = _spd(n, seed=n + tile)
    got = tref.cholesky_blocked(torch.from_numpy(spd), tile)
    assert got.dtype == torch.float32 and tuple(got.shape) == (n, n)
    assert torch.equal(got, torch.tril(got))
    want_ref = np.asarray(jref.cholesky_blocked(jnp.asarray(spd), tile))
    np.testing.assert_allclose(got.numpy(), want_ref, rtol=RTOL, atol=ATOL)
    want_lapack = torch.linalg.cholesky(torch.from_numpy(spd))
    np.testing.assert_allclose(got.numpy(), want_lapack.numpy(), rtol=RTOL,
                               atol=ATOL)
