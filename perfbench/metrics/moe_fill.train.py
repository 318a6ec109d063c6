"""The share of the MoE FFN's expert rows that hold a token's choice
over the traced steps, in %: 100 x the program's counters
``moe.choices`` (N k a dispatch) over ``moe.slots`` (E C a dispatch).
The rest are rows the experts compute for nothing."""
from perfbench.metrics_common import counters


def read(rec):
    if rec.get("kind") != "train":
        return None
    got = counters(rec, "moe.choices", "moe.slots")
    return None if got is None else 100.0 * got[0] / got[1]
