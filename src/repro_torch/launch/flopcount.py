"""FLOP and byte accounting of a PyTorch function, op by op.

The port of the JAX package's ``launch/flopcount.py``, which walks a
jaxpr.  PyTorch has no jaxpr; what it has is the dispatcher, which every
aten op a function runs passes through.  :class:`FlopCounter` is a
``TorchDispatchMode`` that sees each of those ops, runs it, and counts
it by the reference's rules.  Run the function on ``meta`` tensors
(shapes and dtypes, no data): nothing is computed and nothing launches,
and a function whose control flow reads a tensor's value cannot be run
that way, as it cannot be traced in the reference.

Accounting rules (the reference's, by aten op):

* ``mm`` / ``bmm`` / ``addmm`` / ``baddbmm``: 2 * batch * M * N * K
  flops, plus the bytes of their inputs and outputs.
* ``_fft_c2c`` / ``_fft_r2c`` / ``_fft_c2r``: 5 * n * log2(n) flops per
  length-n transform, batched over the other dims (5 * output elements *
  log2 n), plus bytes.
* layout and dtype ops (views, ``t``/``transpose``/``permute``,
  ``expand``, ``slice``/``select``, ``clone``, ``to``/``_to_copy`` on
  the same device) count nothing: the reference skips them as fused.
* zero-flop data ops (``index_select``/``gather``, ``cat``, ``arange``,
  ``where``, ``constant_pad_nd``, ...) count bytes only.
* reductions count one flop per input element, plus bytes.
* every other op is elementwise: one flop per output element, plus the
  bytes of its inputs and outputs.  An op that returns no tensor (a
  check, ``promote_types``) counts nothing.

An operator of this package (``repro_torch::*``) has no meta
implementation: its CPU implementation is the plain version and its CUDA
one launches a kernel.  The counter runs its plain version
(:func:`_plain_versions`) in its place and counts that version's ops, so
a body that calls the Black-Scholes operator is counted by what it
computes.  This is counting only: a wrapper on a CUDA tensor still
launches its kernel and never runs its plain version.

A kernel wrapper called on ``meta`` tensors (``flash_attention``,
``flash_decode``) launches nothing and returns what its kernel
allocates; it hands its plain version to ``metatrace.account``, and
the counter counts that as it counts an operator.

Every count is scaled by ``metatrace.multiplier()``: in a ``meta`` trace
a loop's middle item stands for the items it skips, and a backward op
for the autograd node it belongs to (1 everywhere else).

``torch.utils.flop_counter.FlopCounterMode`` counts the matrix products
only (no bytes, no elementwise ops, 0 for an FFT), so it is not used
here; the tests use it to cross-check the matmul flops.
"""
from __future__ import annotations

import functools
import math

import torch
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _disable_current_modes)
from torch.utils._pytree import tree_flatten

from .. import metatrace

__all__ = ["FlopCounter", "count_step"]

_MATMUL = {"mm", "bmm", "addmm", "baddbmm"}
_FFT = {"_fft_c2c", "_fft_r2c", "_fft_c2r"}
_LAYOUT = {
    "view", "_unsafe_view", "reshape", "as_strided", "alias", "detach",
    "lift_fresh", "t", "transpose", "permute", "expand", "slice", "select",
    "squeeze", "unsqueeze", "unfold", "split", "split_with_sizes", "unbind",
    "chunk", "narrow", "diagonal", "view_as_real", "view_as_complex",
    "_reshape_alias", "clone", "_conj", "resolve_conj", "resolve_neg",
    # factories of constants: the reference's broadcast_in_dim of a literal
    "empty", "empty_like", "empty_strided", "zeros", "zeros_like", "ones",
    "ones_like", "full", "full_like", "scalar_tensor", "new_empty",
    "new_empty_strided", "new_zeros", "new_ones", "new_full",
}
_ZERO_FLOP = {
    "index_select", "gather", "index", "cat", "stack", "arange", "where",
    "constant_pad_nd", "pad", "scatter", "index_put", "index_copy",
    "slice_scatter", "select_scatter", "copy", "copy_", "_to_copy",
    "masked_fill", "flip", "roll", "fill_", "zero_",
}
_REDUCTION = {
    "sum", "mean", "amax", "amin", "max", "min", "prod", "argmax", "argmin",
    "cumsum", "cumprod", "cummax", "logsumexp", "any", "all", "norm",
    "linalg_vector_norm", "var", "std",
}


def _tensors(tree) -> list[torch.Tensor]:
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


def _nbytes(xs) -> int:
    return sum(x.numel() * x.element_size() for x in xs)


def _matmul_flops(name: str, args) -> float:
    """2 * batch * M * N * K of one product op (``addmm``/``baddbmm`` take
    the summand first)."""
    a, b = (args[1], args[2]) if name in ("addmm", "baddbmm") else args[:2]
    return 2.0 * a.numel() * b.shape[-1]          # a: (batch, M, K)


def _fft_length(name: str, args, outs) -> int:
    """The length n of one transform: the transformed dims' sizes, read
    where the transform has its full length (the complex side)."""
    x, dims = args[0], args[1]
    shape = outs[0].shape if name == "_fft_c2r" else x.shape
    return math.prod(int(shape[d]) for d in dims)


@functools.cache
def _plain_versions() -> dict:
    """This package's operators, by name, and the plain PyTorch version
    the counter runs in place of each (same arguments, same outputs)."""
    from ..kernels.black_scholes import ref as bs_ref
    from ..kernels.flash_decode import ref as fd_ref

    def flash_decode(q, k, v, scale, bk):
        return fd_ref.decode_partial(q, k, v, scale=scale)

    return {"repro_torch::black_scholes": bs_ref.black_scholes,
            "repro_torch::flash_decode": flash_decode}


class FlopCounter(TorchDispatchMode):
    """Counts the flops and bytes of every aten op run under it, by the
    rules of the module docstring; ``flops``/``bytes`` hold the totals
    and ``by_op`` the totals of each op name."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.by_op: dict[str, list[float]] = {}
        self._scaled = True

    def __enter__(self):
        metatrace._counters.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        metatrace._counters.remove(self)
        return super().__exit__(*exc)

    def _add(self, name: str, flops: float, nbytes: float) -> None:
        if self._scaled:
            times = metatrace.multiplier()
            flops, nbytes = flops * times, nbytes * times
        self.flops += flops
        self.bytes += nbytes
        row = self.by_op.setdefault(name, [0.0, 0.0])
        row[0] += flops
        row[1] += nbytes

    def _count_inner(self, plain, args, kwargs):
        """Run ``plain`` under an unscaled counter; add its ops' counts,
        each by its rule, scaled once.  Returns its output."""
        inner = FlopCounter()
        inner._scaled = False
        with inner:
            out = plain(*args, **kwargs)
        for name, (flops, nbytes) in inner.by_op.items():
            self._add(name, flops, nbytes)
        return out

    def count_plain(self, plain, args, kwargs) -> None:
        """Count ``plain(*args, **kwargs)`` (``metatrace.account``), run on
        its own: the other modes (a memory tracker) do not see it."""
        with _disable_current_modes():
            self._count_inner(plain, args, kwargs)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func.namespace == "repro_torch":
            plain = _plain_versions().get(func._schema.name)
            if plain is None:
                raise NotImplementedError(
                    f"{func._schema.name} has no plain version to count")
            # counted through its plain version's ops, each by its rule
            return self._count_inner(plain, args, kwargs)
        out = func(*args, **kwargs)
        name = func.overloadpacket.__name__
        outs = _tensors(out)
        if not outs or name in _LAYOUT:
            return out
        ins = _tensors((args, kwargs))
        if name in ("to", "_to_copy") and ins[0].device == outs[0].device:
            return out                    # a dtype change: fused
        nbytes = _nbytes(ins) + _nbytes(outs)
        if name in _MATMUL:
            self._add(name, _matmul_flops(name, args), nbytes)
        elif name in _FFT:
            n = _fft_length(name, args, outs)
            size = sum(o.numel() for o in outs)
            self._add(name, 5.0 * size * max(math.log2(max(n, 2)), 1.0),
                      nbytes)
        elif name in _ZERO_FLOP:
            self._add(name, 0.0, nbytes)
        elif name in _REDUCTION:
            self._add(name, float(sum(x.numel() for x in ins)), nbytes)
        else:
            self._add(name, float(sum(o.numel() for o in outs)), nbytes)
        return out


def count_step(fn, *meta_args) -> dict:
    """Run ``fn`` on ``meta_args`` (``meta`` tensors shaped like its
    inputs) under a :class:`FlopCounter`; returns ``{"flops", "bytes"}``."""
    counter = FlopCounter()
    with counter:
        fn(*meta_args)
    return {"flops": counter.flops, "bytes": counter.bytes}
