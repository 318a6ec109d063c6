"""What every plain reference shares: how it multiplies (:class:`Arith`,
float32 or the fp8 control's precision) and TF32 switched off.  The
equations themselves are each reference module's own, found by name
(``perfbench.common.reference``)."""
from __future__ import annotations

import torch

__all__ = ["Arith", "tf32_off"]


def tf32_off() -> None:
    """Products in true float32 (the reference's precision)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class Arith:
    """How the reference multiplies: ``"f32"`` in float32, or ``"fp8"``
    with both operands rounded to float8 (e4m3, one scale per tensor,
    products accumulated in float32).  The fp8 rounding passes the
    gradient straight through, so a training step's backward products
    read the rounded operands."""

    def __init__(self, precision: str = "f32"):
        if precision not in ("f32", "fp8"):
            raise ValueError(precision)
        self.precision = precision

    def round(self, x):
        if self.precision == "f32":
            return x
        with torch.no_grad():
            amax = x.detach().abs().amax().clamp(min=1e-30)
            s = amax / 448.0
            q = (x.detach() / s).to(torch.float8_e4m3fn).float() * s
        return x + (q - x).detach()

    def mm(self, a, b):
        return self.round(a) @ self.round(b)
