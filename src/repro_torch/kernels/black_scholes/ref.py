"""Plain PyTorch Black-Scholes European option pricing (the JAX package's
``kernels/black_scholes/ref.py``).

The paper's Black-Scholes benchmark prices 2M options in tasks of 512
options — an embarrassingly parallel elementwise workload.  This is the
plain version of the hand-written kernel in ``kernel.py``.
"""
import torch

_SQRT2 = 1.4142135623730951


def _ncdf(x):
    return 0.5 * (1.0 + torch.special.erf(x / _SQRT2))


def black_scholes(spot, strike, t, rate, vol):
    """Returns (call, put) prices; all inputs broadcastable float tensors."""
    spot, strike, t, rate, vol = (torch.as_tensor(a, dtype=torch.float32)
                                  for a in (spot, strike, t, rate, vol))
    sqrt_t = torch.sqrt(t)
    d1 = (torch.log(spot / strike) + (rate + 0.5 * vol * vol) * t) / \
        (vol * sqrt_t)
    d2 = d1 - vol * sqrt_t
    disc = strike * torch.exp(-rate * t)
    call = spot * _ncdf(d1) - disc * _ncdf(d2)
    put = disc * _ncdf(-d2) - spot * _ncdf(-d1)
    return call, put
