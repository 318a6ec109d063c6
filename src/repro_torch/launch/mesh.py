"""Mesh construction.

Functions (not module-level constants), so importing this module never
touches the devices.
"""
from __future__ import annotations

import math

import numpy as np

from .. import dist

__all__ = ["make_mesh", "make_production_mesh"]


def make_production_mesh(*, multi_pod: bool = False) -> dist.Mesh:
    """The reference's production layouts over the local cards.  Single
    pod: (data=16, model=16) = 256 devices.  Multi-pod: (pod=2, data=16,
    model=16) = 512; the ``pod`` axis carries either data parallelism
    (default) or pipeline stages.  Raises with fewer local cards."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes)


def make_mesh(shape, axes, devices=None) -> dist.Mesh:
    """A mesh of ``shape`` named ``axes`` over the first ``prod(shape)``
    of ``devices`` (the local CUDA cards by default; raises without
    CUDA).  Raises when there are fewer devices than the shape asks for,
    as ``jax.make_mesh`` does.  ``dist.logical_devices(n, device)`` gives
    ``n`` devices on one card or on the CPU."""
    shape = tuple(int(s) for s in shape)
    axes = tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in "
                         "length")
    devices = list(dist.local_devices() if devices is None else devices)
    n = math.prod(shape)
    if len(devices) < n:
        raise ValueError(f"a {shape} mesh needs {n} devices, "
                         f"{len(devices)} available")
    arr = np.empty(n, dtype=object)
    arr[:] = devices[:n]
    return dist.Mesh(arr.reshape(shape), axes)
