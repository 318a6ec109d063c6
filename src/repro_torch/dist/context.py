"""The ambient mesh context: which mesh axes carry what.

``MeshContext`` is the one object the model and launch layers consult for
distribution decisions.  It names the axes (data / model / optional pod)
and answers the two derived questions every call site has:

* ``all_data_axes``   — every axis that carries pure data parallelism
  (the pod axis joins it when present);
* ``batch_axes_full`` — the axes a batch dimension may shard over; when
  ``model_in_batch`` is set (recurrent families in train/prefill, where
  per-step tensor parallelism would reshard pathologically) the model
  axis joins the batch too.

A context is installed with :func:`repro_torch.dist.use_mesh` and read
back with :func:`repro_torch.dist.current`; with no context installed
every distribution hook degrades to a local no-op, which is what the
single-device tests rely on.
"""
from __future__ import annotations

import math
from dataclasses import dataclass


@dataclass(frozen=True)
class MeshContext:
    """An activated mesh plus the axis roles."""
    mesh: object
    data_axes: tuple[str, ...] = ("data",)
    model_axis: str = "model"
    pod_axis: str | None = None
    model_in_batch: bool = False

    def __init__(self, mesh, data_axes=("data",), model_axis="model",
                 pod_axis=None, model_in_batch=False):
        if isinstance(data_axes, str):
            data_axes = (data_axes,)
        object.__setattr__(self, "mesh", mesh)
        object.__setattr__(self, "data_axes", tuple(data_axes))
        object.__setattr__(self, "model_axis", model_axis)
        object.__setattr__(self, "pod_axis", pod_axis)
        object.__setattr__(self, "model_in_batch", bool(model_in_batch))

    # -- axis queries -------------------------------------------------------
    def axis_size(self, name: str | None) -> int:
        if name is None:
            return 1
        return int(self.mesh.shape[name])

    @property
    def all_data_axes(self) -> tuple[str, ...]:
        """Axes carrying data parallelism (pod included when present)."""
        axes = self.data_axes
        if self.pod_axis is not None:
            axes = (self.pod_axis,) + axes
        return axes

    @property
    def batch_axes_full(self) -> tuple[str, ...]:
        """Axes a batch dim may shard over (model joins under
        ``model_in_batch``)."""
        axes = self.all_data_axes
        if self.model_in_batch:
            axes = axes + (self.model_axis,)
        return axes

    def dp_size(self) -> int:
        return math.prod(self.axis_size(a) for a in self.all_data_axes)

    def full_batch_size(self) -> int:
        return math.prod(self.axis_size(a) for a in self.batch_axes_full)
