"""Device ms a traced training step of the events launched inside the
program's spans ``moe/ffn`` and ``moe/ffn.bwd`` (route, dispatch,
experts, combine; forward, recomputed and backward), less the block
recomputed inside ``moe/ffn.bwd`` (``model/block``) but for its own
MoE FFN."""
from perfbench.metrics_common import span_ms


def read(rec):
    return span_ms(rec, "train", rec.get("traced_steps"),
                   ["moe/ffn", "moe/ffn.bwd"], ["model/block"])
