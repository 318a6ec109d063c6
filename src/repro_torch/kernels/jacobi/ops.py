"""Public Jacobi op.

The halo kernel in ``kernel.py`` runs the jacobi app's stencil body a
whole wave group at a time through the wave registry.
"""
from . import ref


def jacobi_step(x):
    return ref.jacobi_step(x)


def jacobi(x, iters: int = 1):
    for _ in range(iters):
        x = jacobi_step(x)
    return x
