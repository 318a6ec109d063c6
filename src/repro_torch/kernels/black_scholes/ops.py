"""Public Black-Scholes op: option batches of any length.

It goes through the operator ``repro_torch::black_scholes``: its CPU
implementation is the plain version and its CUDA implementation
launches the kernel (``kernel.black_scholes``), neither falling back to
the other.  The operator has a vmap rule that folds the task axis into
the option axis, so the Black-Scholes app's ``_price`` body launches
once per task on a host worker and once per group under the staged
executor's ``torch.func.vmap``.

The operator is declared with ``torch.library``'s schema API
(``Library.define``/``impl``/``register_vmap``), not
``torch.library.custom_op``: the latter imports ``torch._dynamo`` on its
first call, seconds of start-up (PERF.md), and adds a layer of Python
to every call.
"""
import torch

from . import kernel

__all__ = ["black_scholes"]

_LIB = torch.library.Library("repro_torch", "FRAGMENT")
_LIB.define("black_scholes(Tensor spot, Tensor strike, Tensor t, "
            "Tensor rate, Tensor vol) -> (Tensor, Tensor)")
_LIB.impl("black_scholes", kernel.black_scholes, "CPU")
_LIB.impl("black_scholes", kernel.black_scholes, "CUDA")
_OP = torch.ops.repro_torch.black_scholes.default


def _black_scholes_vmap(info, in_dims, *xs):
    n = info.batch_size
    xs = [(x.expand(n, *x.shape) if d is None else x.movedim(d, 0))
          .contiguous() for x, d in zip(xs, in_dims)]
    return _OP(*xs), (0, 0)


torch.library.register_vmap("repro_torch::black_scholes",
                            _black_scholes_vmap, lib=_LIB)


def black_scholes(spot, strike, t, rate, vol):
    """Price a batch of options: ``(call, put)``.  Inputs broadcast to
    one shape and are taken as float32."""
    xs = torch.broadcast_tensors(*(torch.as_tensor(x, dtype=torch.float32)
                                   for x in (spot, strike, t, rate, vol)))
    return _OP(*(x.contiguous() for x in xs))
