"""Plain PyTorch tile ops of tiled right-looking Cholesky (the JAX
package's ``kernels/cholesky/ref.py``).

The paper's benchmark: 2Kx2K doubles in 128x128 tiles.  Tile ops:

* ``potrf``  — Cholesky of a diagonal tile
* ``trsm``   — panel solve  X L^T = A  (X strictly below the diagonal tile)
* ``update`` — trailing update  C - A @ B^T  (SYRK on the diagonal, GEMM off)

``potrf`` and ``trsm`` are library calls (``torch.linalg``), as the
reference leaves them to XLA's triangular primitives; ``update`` has a
hand-written kernel (``kernels/matmul/kernel.py``).
"""
import torch


def potrf(a):
    """Lower-triangular Cholesky factor of a (tile-sized) SPD matrix."""
    return torch.linalg.cholesky(a)


def trsm(l, a):
    """Solve ``x @ l.T = a`` for x (l lower-triangular)."""
    return torch.linalg.solve_triangular(l, a.mT, upper=False).mT


def update(c, a, b):
    """Trailing update ``c - a @ b.T`` (f32/f64 accumulation)."""
    acc = torch.promote_types(c.dtype, torch.float32)
    prod = torch.matmul(a.to(acc), b.to(acc).mT)
    return (c.to(acc) - prod).to(c.dtype)
