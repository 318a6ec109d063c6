"""Admission control for the serving session: bound in-flight bytes
(the JAX package's ``serve/admission.py``, over the port's tracker).

The controller is the serving analogue of the paper's fixed-size
descriptor pool (§3.3): the runtime never holds more work than a
configured footprint budget.  Every request declares the bytes of the
block regions it will touch; the controller admits while the in-flight
total stays under ``budget_bytes``, and beyond that either queues the
request (``on_saturation="queue"``, FIFO, admitted as releases free
capacity) or rejects it outright (``"reject"``, load shedding).  A
request larger than the whole budget can never run and is always
rejected, so a queue admits in bounded time.

A secondary, latency-oriented bound rides on the live per-worker queue
depths the scheduler (and, when enabled, the ``repro_torch.obs`` tracker)
maintains: with ``max_home_depth > 0`` admission also defers while any
worker ring holds more than that many in-flight tasks — back-pressure
from execution, not just memory.

Every decision is emitted as an ``admission_*`` event through the
session's tracker, and the counters surface as the ``admission_*``
fields of :class:`repro_torch.core.RuntimeStats` (the invariant
``submitted == admitted + rejected`` holds once the session closes).
"""
from __future__ import annotations

from typing import Callable

from ..obs.tracker import NULL_TRACKER

__all__ = ["AdmissionController", "RequestRejected",
           "ADMIT", "DEFER", "REJECT"]

ADMIT = "admit"
DEFER = "defer"
REJECT = "reject"

_SATURATION = ("queue", "reject")


class RequestRejected(RuntimeError):
    """The admission controller refused a request (budget/oversize)."""


class AdmissionController:
    """Byte-budget admission over declared request footprints."""

    def __init__(self, budget_bytes: int, *, on_saturation: str = "queue",
                 max_home_depth: int = 0,
                 depths_fn: Callable[[], dict] | None = None,
                 obs=NULL_TRACKER):
        if budget_bytes < 1:
            raise ValueError("budget_bytes must be >= 1")
        if on_saturation not in _SATURATION:
            raise ValueError(f"on_saturation must be one of {_SATURATION}, "
                             f"got {on_saturation!r}")
        if max_home_depth < 0:
            raise ValueError("max_home_depth must be >= 0 (0 = off)")
        self.budget_bytes = int(budget_bytes)
        self.on_saturation = on_saturation
        self.max_home_depth = int(max_home_depth)
        self._depths_fn = depths_fn
        self.obs = obs
        self.in_flight_bytes = 0
        self.peak_in_flight_bytes = 0
        self.submitted = 0
        self.admitted = 0
        self.rejected = 0
        self.deferred = 0

    # -- decisions ----------------------------------------------------------
    def _saturated_by_depth(self) -> bool:
        if not self.max_home_depth or self._depths_fn is None:
            return False
        depths = self._depths_fn() or {}
        return any(d > self.max_home_depth for d in depths.values())

    def try_admit(self, request: str, nbytes: int) -> str:
        """Decide one arrival: ``"admit"``, ``"defer"`` or ``"reject"``.

        Call exactly once per submitted request; re-admission of a
        deferred request goes through :meth:`admit_deferred` instead so
        the ``submitted`` counter stays one-per-request.
        """
        self.submitted += 1
        if nbytes > self.budget_bytes:
            return self._reject(request, nbytes, "oversize")
        if self.in_flight_bytes + nbytes > self.budget_bytes \
                or self._saturated_by_depth():
            if self.on_saturation == "reject":
                return self._reject(request, nbytes, "budget")
            self.deferred += 1
            if self.obs.enabled:
                self.obs.emit("admission_defer", request=request,
                              bytes=nbytes,
                              in_flight_bytes=self.in_flight_bytes,
                              queued=True)
            return DEFER
        self._admit(request, nbytes)
        return ADMIT

    def has_room(self, nbytes: int) -> bool:
        """Would a deferred request of ``nbytes`` fit right now?"""
        return self.in_flight_bytes + nbytes <= self.budget_bytes \
            and not self._saturated_by_depth()

    def admit_deferred(self, request: str, nbytes: int) -> None:
        """Admit a previously deferred request (caller checked
        :meth:`has_room`)."""
        self._admit(request, nbytes)

    def reject_deferred(self, request: str, nbytes: int,
                        reason: str = "closed") -> None:
        """Resolve a still-queued request as rejected (session close)."""
        self._reject(request, nbytes, reason)

    def _admit(self, request: str, nbytes: int) -> None:
        self.admitted += 1
        self.in_flight_bytes += nbytes
        if self.in_flight_bytes > self.peak_in_flight_bytes:
            self.peak_in_flight_bytes = self.in_flight_bytes
        if self.obs.enabled:
            self.obs.emit("admission_admit", request=request, bytes=nbytes,
                          in_flight_bytes=self.in_flight_bytes)

    def _reject(self, request: str, nbytes: int, reason: str) -> str:
        self.rejected += 1
        if self.obs.enabled:
            self.obs.emit("admission_reject", request=request, bytes=nbytes,
                          in_flight_bytes=self.in_flight_bytes,
                          reason=reason)
        return REJECT

    # -- completion ---------------------------------------------------------
    def release(self, request: str, nbytes: int,
                latency_s: float = 0.0) -> None:
        """An admitted request completed: return its bytes to the budget."""
        self.in_flight_bytes -= nbytes
        assert self.in_flight_bytes >= 0, "released more than admitted"
        if self.obs.enabled:
            self.obs.emit("admission_release", request=request,
                          bytes=nbytes,
                          in_flight_bytes=self.in_flight_bytes,
                          latency_s=latency_s)

    def __repr__(self):
        return (f"<AdmissionController {self.in_flight_bytes}/"
                f"{self.budget_bytes}B in flight, "
                f"{self.admitted}/{self.submitted} admitted>")
