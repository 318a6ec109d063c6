"""Black-Scholes pricing: hand-written CUDA for Hopper.

Replaces ``black_scholes_pallas`` of the JAX package
(``src/repro/kernels/black_scholes/kernel.py``): European call and put
prices of a flat batch of options (``csrc/black_scholes.cu``).  The TPU
kernel's (rows, 128) layout and 1.0 padding are lane artefacts and are
not carried over.

Bound on an H100: memory — 7 x 4 B per option (five inputs read, two
prices written) against some 60 flops; 2,097,152 options move 58.7 MB,
about 17.5 us at 3.35 TB/s.  One thread per option, or per four options
with 16-byte loads where every pointer is aligned; the full-precision
``erff``/``logf``/``expf``/``sqrtf`` hold rtol 1e-5 / atol 1e-3.

The wrapper runs the plain version (``ref.black_scholes``) for tensors on
the CPU and launches the kernel for tensors on a CUDA device, and counts
the launches in ``black_scholes.launches``.
"""
import ctypes
import functools

import torch

from .. import _build
from . import ref

__all__ = ["black_scholes", "black_scholes_plain"]


@functools.cache
def _lib():
    """The built library, its entry's C signature set once."""
    lib = _build.load("black_scholes")
    lib.bddt_black_scholes.argtypes = (
        [ctypes.c_void_p] * 7 + [ctypes.c_longlong, ctypes.c_void_p])
    lib.bddt_black_scholes.restype = ctypes.c_int
    return lib


def black_scholes_plain(spot, strike, t, rate, vol):
    """``(call, put)`` of ``ref.black_scholes`` in plain PyTorch."""
    return ref.black_scholes(spot, strike, t, rate, vol)


def black_scholes(spot, strike, t, rate, vol):
    """``(call, put)`` prices of options given by five float32 tensors of
    one shape: the plain version on the CPU, one kernel launch on CUDA
    (contiguous tensors on one device)."""
    xs = (spot, strike, t, rate, vol)
    shape = tuple(spot.shape)
    if any(tuple(x.shape) != shape for x in xs):
        raise ValueError(f"expected five tensors of one shape, got "
                         f"{[tuple(x.shape) for x in xs]}")
    kinds = {x.device.type for x in xs}
    if kinds == {"cpu"}:
        return black_scholes_plain(*xs)
    if kinds != {"cuda"}:
        raise ValueError(f"operands on mixed or unsupported devices: "
                         f"{sorted(str(x.device) for x in xs)}")
    for name, x in zip(("spot", "strike", "t", "rate", "vol"), xs):
        _build.require(x, name, shape, device=spot.device)
    call = torch.empty_like(spot)
    put = torch.empty_like(spot)
    rc = _lib().bddt_black_scholes(
        *(x.data_ptr() for x in xs), call.data_ptr(), put.data_ptr(),
        spot.numel(), _build.stream_handle(spot.device))
    _build.check(rc, "black_scholes")
    black_scholes.launches += 1
    return call, put


black_scholes.launches = 0
