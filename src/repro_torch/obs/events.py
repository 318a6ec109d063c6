"""The observability event schema (one schema, every executor).

Every executor reports through the same structured per-wave events, so a
trace reads identically whether the program ran staged, sharded, on the
host threads, or through the DES — the reproduction's analogue of the
paper's §6 measurement methodology, where per-core timestamped counters
(busy/idle/flush breakdowns, per-controller load) are what actually
locate the contention and locality effects.

An :class:`Event` is ``(kind, ts, data)``: ``ts`` is seconds since the
tracker started (monotonic clock) and ``data`` is a flat JSON-safe dict
whose required keys are fixed per kind by :data:`EVENT_FIELDS`.  The
schema is versioned (:data:`EVENT_SCHEMA`) and pinned by
``tests/test_obs.py`` — extending an event is adding *optional* keys;
removing or renaming a required key is a schema bump.

Kinds:

* ``trace_header``   — first record of a JSONL trace file; carries the
  schema version string.
* ``wave_open``      — a wavefront starts dispatching: task and group
  counts, which executor.
* ``wave_close``     — the wavefront drained: dispatch wall time, how
  many dispatches it took, and the *measured* tile movement deltas
  (``TileTraffic`` snapshots around the wave, so per-wave
  ``bytes_moved``/``bytes_staged`` sum exactly to ``RuntimeStats``).
* ``dispatch``       — one batched (or single) dispatch: function name,
  task count, dispatch mode (``jit``/``vmap``/``shard_map``/
  ``vmap_device``/``pallas``) and its wall time.
* ``kernel_dispatch``— the wave-kernel backend decided how one group
  dispatches (emitted only under ``kernel_backend="pallas"``):
  ``backend`` is ``"pallas"`` (fused grid) or ``"xla"`` (fallback), and
  ``reason`` names why a fallback was taken (``"single_task"``,
  ``"non_rectangular"``, ``"mixed_dtype"``, ``"grid_overflow"``, ...;
  empty on the pallas path).
* ``queue_depth``    — a per-device (or per-worker) queue depth changed;
  the tracker keeps the live map, which the sharded executor feeds back
  into ``placement.rebalance_owners``.
* ``owner_override`` — the contention-aware owner override spilled tasks.
* ``tile_cache``     — one host worker's pinned-tile-cache hit/miss
  counters (reported at shutdown).
* ``sim_predict``    — the DES barrier's predicted makespan vs the
  configured serial cost of the same tasks (``sim.sequential_time``).
* ``dep_msg``        — the sharded dependence manager moved messages over
  one home's MPB channel (``msg`` is ``dep_query``/``dep_grant``/
  ``release``).  One event per *logical* descriptor, independent of how
  descriptors were packed into envelopes.
* ``dep_batch``      — one multi-descriptor envelope crossed a home's
  MPB ring: which manager, the direction (``post`` master->manager,
  ``grant`` manager->master), how many descriptors it carried and the
  32-byte MPB lines it occupied.
* ``pump_idle``      — a dependence pump thread found every inbox it
  services empty and parked (``dep_pump="threaded"`` only): the first
  home the thread services and its cumulative idle-wait count.
* ``manager_admit``  — one per-home manager admitted a footprint slice:
  which manager, the admitted task, how many dependences its grant
  carried, and the channel depth at send time.
* ``stats``          — the runtime's final :class:`RuntimeStats` as its
  schema-tagged dict (``RuntimeStats.to_dict``), emitted at shutdown.
* ``admission_admit`` / ``admission_defer`` / ``admission_reject`` /
  ``admission_release`` — the serving admission controller
  (``repro.serve``) decided one request's fate against the in-flight
  byte budget: the request id, its footprint bytes, and the in-flight
  total after the decision; rejects carry a ``reason``
  (``"budget"``/``"oversize"``/``"closed"``), releases carry the
  request's latency.
* ``ckpt_save`` / ``ckpt_restore`` — one epoch-tagged tile checkpoint
  of the serving session's shared ``BlockArray`` state committed to
  (or was restored from) disk: epoch, array/tile counts, total bytes.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field

__all__ = ["EVENT_SCHEMA", "EVENT_FIELDS", "Event", "validate_event"]

EVENT_SCHEMA = "repro-obs/1"

# kind -> required data keys.  Emitters may add optional keys; removing
# a required key is a schema bump.
EVENT_FIELDS: dict[str, frozenset] = {
    "trace_header": frozenset({"schema"}),
    "wave_open": frozenset({"wave", "executor", "tasks", "groups"}),
    "wave_close": frozenset({"wave", "executor", "tasks", "wall_s",
                             "dispatches", "tile_moves", "bytes_moved",
                             "bytes_staged"}),
    "dispatch": frozenset({"wave", "executor", "fn", "tasks", "mode",
                           "wall_s"}),
    "kernel_dispatch": frozenset({"wave", "executor", "fn", "tasks",
                                  "backend", "reason"}),
    "queue_depth": frozenset({"channel", "depth"}),
    "owner_override": frozenset({"wave", "spilled"}),
    "tile_cache": frozenset({"worker", "hits", "misses"}),
    "sim_predict": frozenset({"tasks", "predicted_s", "sequential_s"}),
    "dep_msg": frozenset({"manager", "msg", "count"}),
    "dep_batch": frozenset({"manager", "direction", "descriptors",
                            "lines"}),
    "pump_idle": frozenset({"manager", "waits"}),
    "manager_admit": frozenset({"manager", "task", "deps", "depth"}),
    "stats": frozenset({"stats"}),
    "admission_admit": frozenset({"request", "bytes", "in_flight_bytes"}),
    "admission_defer": frozenset({"request", "bytes", "in_flight_bytes",
                                  "queued"}),
    "admission_reject": frozenset({"request", "bytes", "in_flight_bytes",
                                   "reason"}),
    "admission_release": frozenset({"request", "bytes", "in_flight_bytes",
                                    "latency_s"}),
    "ckpt_save": frozenset({"epoch", "arrays", "tiles", "bytes"}),
    "ckpt_restore": frozenset({"epoch", "arrays", "tiles", "bytes"}),
}


@dataclass(frozen=True)
class Event:
    """One structured observation: ``kind`` names the schema entry,
    ``ts`` is seconds since tracker start, ``data`` the payload."""
    kind: str
    ts: float
    data: dict = field(default_factory=dict)

    def to_record(self) -> dict:
        """The flat JSONL representation (``kind``/``ts`` + payload)."""
        return {"kind": self.kind, "ts": self.ts, **self.data}

    def to_json(self) -> str:
        return json.dumps(self.to_record(), sort_keys=True)

    @classmethod
    def from_record(cls, rec: dict) -> "Event":
        rec = dict(rec)
        kind = rec.pop("kind")
        ts = rec.pop("ts", 0.0)
        return cls(kind=kind, ts=float(ts), data=rec)


def validate_event(ev: Event) -> list[str]:
    """Schema problems with ``ev`` (empty list = valid)."""
    bad: list[str] = []
    required = EVENT_FIELDS.get(ev.kind)
    if required is None:
        return [f"unknown event kind {ev.kind!r}"]
    missing = required - set(ev.data)
    if missing:
        bad.append(f"{ev.kind}: missing required fields {sorted(missing)}")
    if not isinstance(ev.ts, (int, float)) or ev.ts < 0:
        bad.append(f"{ev.kind}: ts must be a non-negative number, "
                   f"got {ev.ts!r}")
    return bad
