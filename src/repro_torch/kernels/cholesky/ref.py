"""Plain PyTorch tile ops of tiled right-looking Cholesky (the JAX
package's ``kernels/cholesky/ref.py``).

The paper's benchmark: 2Kx2K doubles in 128x128 tiles.  Tile ops:

* ``potrf``  — Cholesky of a diagonal tile
* ``trsm``   — panel solve  X L^T = A  (X strictly below the diagonal tile)
* ``update`` — trailing update  C - A @ B^T  (SYRK on the diagonal, GEMM off)

and :func:`cholesky_blocked`, the sequential loop nest over them, the
oracle of the task-graph version.

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


def cholesky_blocked(a, tile: int):
    """Tiled right-looking Cholesky as a sequential loop nest over the
    tile ops (the reference's oracle of the task-graph version): the
    lower factor of ``a``, zero above the diagonal."""
    n = a.shape[0]
    g = n // tile
    t = {}
    for i in range(g):
        for j in range(i + 1):
            t[i, j] = a[i * tile:(i + 1) * tile, j * tile:(j + 1) * tile]
    for k in range(g):
        t[k, k] = potrf(t[k, k])
        for i in range(k + 1, g):
            t[i, k] = trsm(t[k, k], t[i, k])
        for i in range(k + 1, g):
            for j in range(k + 1, i + 1):
                t[i, j] = update(t[i, j], t[i, k], t[j, k])
    out = torch.zeros_like(a)
    for i in range(g):
        for j in range(i + 1):
            out[i * tile:(i + 1) * tile, j * tile:(j + 1) * tile] = t[i, j]
    return torch.tril(out)
