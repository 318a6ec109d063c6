"""Streaming task-graph serving over the BDDT-SCC runtime.

Continuous ingestion instead of batch drain: requests arrive as small
task graphs against shared long-lived ``BlockArray`` state, resolve
through per-request ``TaskFuture`` cones, and an admission controller
bounds the in-flight footprint bytes; shared state checkpoints per home
through ``repro_torch.ckpt`` (epoch-tagged, async, bit-identical restore).

Entry point: :class:`Session`.  ``repro_torch.serve_lm`` serves decode
requests against a KV arena through it.
"""
from .admission import AdmissionController, RequestRejected
from .session import RequestHandle, ServeConfig, Session, footprint_nbytes

__all__ = ["Session", "ServeConfig", "RequestHandle",
           "AdmissionController", "RequestRejected", "footprint_nbytes"]
