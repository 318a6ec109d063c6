"""The fullest expert's choices over the balanced load N k / E, the
largest over the traced steps' dispatches, in %: 100 x ``moe.peak``
(the fullest expert's choices over C) x ``moe.slots`` / ``moe.choices``.
100% is a balanced router, E / k x 100% all of a dispatch's tokens on
one expert."""
from perfbench.metrics_common import counters


def read(rec):
    if rec.get("kind") != "train":
        return None
    got = counters(rec, "moe.peak", "moe.choices", "moe.slots")
    return None if got is None else 100.0 * got[0] * got[2] / got[1]
