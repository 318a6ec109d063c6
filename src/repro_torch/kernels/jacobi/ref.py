"""Plain PyTorch version of the Jacobi 5-point stencil sweep (the JAX
package's ``kernels/jacobi/ref.py``).

Interior points become the mean of their four neighbours; boundary points
are fixed (Dirichlet), matching the paper's Jacobi-method benchmark
(4Kx4K floats, 512x512 tiles, 16 iterations).  Leading batch axes are
allowed; nothing is written in place.
"""
import torch


def jacobi_step(x):
    if x.shape[-2] < 3 or x.shape[-1] < 3:
        return x                       # no interior: every point is fixed
    up = x[..., :-2, 1:-1]
    down = x[..., 2:, 1:-1]
    left = x[..., 1:-1, :-2]
    right = x[..., 1:-1, 2:]
    interior = 0.25 * (up + down + left + right)
    mid = torch.cat([x[..., 1:-1, :1], interior, x[..., 1:-1, -1:]], dim=-1)
    return torch.cat([x[..., :1, :], mid, x[..., -1:, :]], dim=-2)


def jacobi(x, iters: int = 1):
    for _ in range(iters):
        x = jacobi_step(x)
    return x
