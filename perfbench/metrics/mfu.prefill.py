"""The model's share of the card's bf16 peak over the traced prefills:
their model operations (``perfbench.flops.prefill_flops``) over their
synchronized walls, in %."""
from perfbench import flops


def read(rec):
    walls = rec.get("prefill_s")
    if rec.get("kind") != "serve" or not walls or rec.get("peak") is None:
        return None
    work = sum(flops.prefill_flops(rec["config"], b, n)
               for b, n in rec["prefills"])
    return 100.0 * work / sum(walls) / rec["peak"]["bf16_flops_per_s"]
