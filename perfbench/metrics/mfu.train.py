"""The model's share of the card's bf16 peak over the traced training
steps: their model operations (``perfbench.flops.train_step_flops``)
over their synchronized wall, in %."""
from perfbench import flops


def read(rec):
    if rec.get("kind") != "train" or not rec.get("traced_steps") or \
            rec.get("peak") is None:
        return None
    tr = rec["traffic"]
    work = rec["traced_steps"] * flops.train_step_flops(
        rec["config"], tr["batch"], tr["seq"])
    return 100.0 * work / rec["traced_wall_s"] / \
        rec["peak"]["bf16_flops_per_s"]
