"""Batched tile GEMM and tile update: hand-written CUDA for Hopper.

Replaces ``matmul_pallas`` and ``tile_update_pallas`` of the JAX package
(``src/repro/kernels/matmul/kernel.py``).  The Pallas kernels work on one
(M,K)x(K,N) product and the reference runs them once per task inside its
fused wave grid; here one launch serves a whole wave group, with the task
axis as the grid's outermost axis (``csrc/matmul.cu``).

Bound on an H100 (SXM, 700 W): memory at both waves.  The matmul app's
wave (256 tasks of 64^3 f32) moves 16.8 MB, 5.0 us; the Cholesky update's
wave (120 tasks of 128^3) 31.5 MB, 9.4 us.  One kernel body serves both:
32-deep slices of the operands stream through a three-stage ``cp.async``
ring (at K <= 64 the whole depth is in flight before the first product)
and the products run on the tensor cores as 3xTF32 (each operand split
into a tf32 high part and a tf32 remainder, three ``mma.sync`` products
summed in f32), which keeps f32-level accuracy where plain TF32 would
miss the reference's 1e-4.  The GEMM reads b in its own (K,N) layout, and
reads c's tile into registers while the operands load; the product is
accumulated from zero and added to c, the reference's order.  Its blocks
are 64 x 64 outputs; the update's 64 x 128.

Each wrapper runs its plain version (``ref.py``) for tensors on the CPU
and launches the kernel for tensors on a CUDA device, and counts the
launches in ``<wrapper>.launches``.
"""
import ctypes
import functools

import torch

from .. import _build
from . import ref

__all__ = ["matmul_batched", "tile_update_batched",
           "matmul_batched_plain", "tile_update_batched_plain"]

_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


@functools.cache
def _lib():
    """The built library, its entries' C signatures set once."""
    lib = _build.load("matmul")
    for fn in (lib.bddt_matmul_batched, lib.bddt_tile_update_batched):
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return lib


def matmul_batched_plain(a, b, c):
    """``c[t] + a[t] @ b[t]`` in plain PyTorch."""
    return ref.matmul(a, b, c)


def tile_update_batched_plain(c, a, b):
    """``c[t] - a[t] @ b[t]^T`` in plain PyTorch."""
    return ref.tile_update(c, a, b)


def _device_of(*xs: torch.Tensor) -> str:
    kinds = {x.device.type for x in xs}
    if kinds == {"cpu"}:
        return "cpu"
    if kinds == {"cuda"}:
        return "cuda"
    raise ValueError(f"operands on mixed or unsupported devices: "
                     f"{sorted(str(x.device) for x in xs)}")


def matmul_batched(a, b, c):
    """``out[t] = c[t] + a[t] @ b[t]`` for a (n,M,K), b (n,K,N), c (n,M,N)
    float32: the plain version on the CPU, one kernel launch on CUDA."""
    if _device_of(a, b, c) == "cpu":
        return matmul_batched_plain(a, b, c)
    n, m, k = a.shape
    nn = b.shape[-1]
    _build.require(a, "a", (n, m, k))
    _build.require(b, "b", (n, k, nn), device=a.device)
    _build.require(c, "c", (n, m, nn), device=a.device)
    out = torch.empty_like(c)
    rc = _lib().bddt_matmul_batched(
        a.data_ptr(), b.data_ptr(), c.data_ptr(), out.data_ptr(),
        n, m, nn, k, _build.stream_handle(a.device))
    _build.check(rc, "matmul_batched")
    matmul_batched.launches += 1
    return out


def tile_update_batched(c, a, b):
    """``out[t] = c[t] - a[t] @ b[t]^T`` for c (n,M,N), a (n,M,K),
    b (n,N,K) float32: the plain version on the CPU, one kernel launch on
    CUDA."""
    if _device_of(c, a, b) == "cpu":
        return tile_update_batched_plain(c, a, b)
    n, m, k = a.shape
    nn = b.shape[1]
    _build.require(a, "a", (n, m, k))
    _build.require(b, "b", (n, nn, k), device=a.device)
    _build.require(c, "c", (n, m, nn), device=a.device)
    out = torch.empty_like(c)
    rc = _lib().bddt_tile_update_batched(
        c.data_ptr(), a.data_ptr(), b.data_ptr(), out.data_ptr(),
        n, m, nn, k, _build.stream_handle(a.device))
    _build.check(rc, "tile_update_batched")
    tile_update_batched.launches += 1
    return out


matmul_batched.launches = 0
tile_update_batched.launches = 0
