"""The flash attention kernel's share of its roofline over the traced
prefills: the sum of each launch's bound (``perfbench.flops.bound_s`` of
``flash_work``: the causal attention's operations and its Q, K, V and O
bytes) over the sum of the kernel's device times, in %.  The kernel's
names come from ``perfbench/kernels.json``; the launches found (inside
the prefills' host ranges where the trace has them, else anywhere in the
traced batches: decode does not launch the kernel) have to be one a
layer a prefill, or nothing is read."""
import pathlib

from perfbench import common, flops

NAMES = common.load_json(pathlib.Path(__file__).resolve().parents[1] /
                         "kernels.json")["flash_attention"]


def read(rec):
    tr = rec.get("trace")
    if rec.get("kind") != "serve" or tr is None or rec.get("peak") is None:
        return None
    windows = tr.ranges("perfbench/prefill") or None
    times = tr.kernel_seconds(windows, NAMES)
    layers = rec["config"]["num_hidden_layers"]
    if not times or len(times) != layers * len(rec["prefills"]):
        return None
    bound = sum(layers * flops.bound_s(*flops.flash_work(rec["config"], b, n),
                                       rec["peak"])
                for b, n in rec["prefills"])
    return 100.0 * bound / sum(times)
