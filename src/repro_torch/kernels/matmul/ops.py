"""Public matmul ops used by the paper-benchmark tasks.

These are the task bodies' plain entries; the batched CUDA kernels in
``kernel.py`` run them a whole wave group at a time through the wave
registry (``repro_torch.core.wavekernel``).
"""
from . import ref


def matmul(a, b, c=None):
    """``c + a @ b`` (``c`` optional)."""
    return ref.matmul(a, b, c)


def tile_update(c, a, b):
    """``c - a @ b^T`` — GEMM/SYRK trailing update for tiled Cholesky."""
    return ref.tile_update(c, a, b)
