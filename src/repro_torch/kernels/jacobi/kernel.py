"""Batched Jacobi halo stencil: hand-written CUDA for Hopper.

Replaces ``jacobi_step_pallas`` of the JAX package
(``src/repro/kernels/jacobi/kernel.py``) where the jacobi app runs it:
each task sweeps its halo region (its tile plus the neighbouring tiles)
once and keeps its own tile at ``(r0, c0)`` — ``jacobi_step`` followed by
``jax.lax.dynamic_slice``, start clamped so the tile fits.  One launch
serves a whole wave group (``csrc/jacobi.cu``).

Bound on an H100: memory — about 2 MiB read and written per 512^2 tile
against 4 flops a point.  The kernel reads only the (TH+2) x (TW+2)
window around the tile, not the whole halo, with each warp on 32
consecutive floats of a row.

The wrapper runs the plain version for tensors on the CPU, launches the
kernel for tensors on a CUDA device, and counts launches in
``jacobi_halo_batched.launches``.
"""
import ctypes
import functools

import torch

from .. import _build
from . import ref

__all__ = ["jacobi_halo_batched", "jacobi_halo_batched_plain"]


@functools.cache
def _lib():
    """The built library, its entry's C signature set once."""
    lib = _build.load("jacobi")
    lib.bddt_jacobi_halo_batched.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    lib.bddt_jacobi_halo_batched.restype = ctypes.c_int
    return lib


def jacobi_halo_batched_plain(halo, r0, c0, tile_shape):
    """``dynamic_slice(jacobi_step(halo[t]), (r0[t], c0[t]), tile_shape)``
    for every task ``t``, in plain PyTorch."""
    n, h, w = halo.shape
    th, tw = tile_shape
    full = ref.jacobi_step(halo)
    dev = halo.device
    rows = r0.to(dev).clamp(0, h - th)[:, None] + torch.arange(th, device=dev)
    cols = c0.to(dev).clamp(0, w - tw)[:, None] + torch.arange(tw, device=dev)
    task = torch.arange(n, device=dev)[:, None, None]
    return full[task, rows[:, :, None], cols[:, None, :]]


def jacobi_halo_batched(halo, r0, c0, tile_shape):
    """Task ``t``'s tile of one Jacobi sweep over ``halo[t]`` (n,H,W)
    float32, at offsets ``r0[t]``, ``c0[t]`` (integer ``(n,)`` tensors on
    the same device): the plain version on the CPU, one kernel launch on
    CUDA.  Returns (n, *tile_shape)."""
    th, tw = (int(s) for s in tile_shape)
    if halo.device.type == "cpu":
        return jacobi_halo_batched_plain(halo, r0, c0, (th, tw))
    n, h, w = halo.shape
    if not (0 < th <= h and 0 < tw <= w):
        raise ValueError(f"tile {(th, tw)} does not fit the halo {(h, w)}")
    _build.require(halo, "halo", (n, h, w))
    r0 = r0.to(torch.int64).contiguous()
    c0 = c0.to(torch.int64).contiguous()
    _build.require(r0, "r0", (n,), torch.int64, device=halo.device)
    _build.require(c0, "c0", (n,), torch.int64, device=halo.device)
    out = torch.empty((n, th, tw), dtype=halo.dtype, device=halo.device)
    rc = _lib().bddt_jacobi_halo_batched(
        halo.data_ptr(), r0.data_ptr(), c0.data_ptr(), out.data_ptr(),
        n, h, w, th, tw, _build.stream_handle(halo.device))
    _build.check(rc, "jacobi_halo_batched")
    jacobi_halo_batched.launches += 1
    return out


jacobi_halo_batched.launches = 0
