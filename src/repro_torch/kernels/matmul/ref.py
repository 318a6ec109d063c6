"""Plain PyTorch versions of the tiled matmul ops (the JAX package's
``kernels/matmul/ref.py``).  Shapes may carry leading batch axes."""
import torch


def matmul(a, b, c=None):
    """``c + a @ b`` (``c`` defaults to zero), f32 accumulation."""
    out = torch.matmul(a.float(), b.float())
    if c is not None:
        out = c.float() + out
    return out.to(a.dtype)


def tile_update(c, a, b):
    """Cholesky-style trailing update: ``c - a @ b^T`` (f32 accumulation)."""
    prod = torch.matmul(a.float(), b.float().mT)
    return (c.float() - prod).to(c.dtype)
