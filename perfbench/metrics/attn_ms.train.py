"""Device ms a traced training step of the events launched inside the
program's spans ``attn/core`` and ``attn/core.bwd`` (the attention core,
forward, recomputed and backward), less a block recomputed inside one of
them (``model/block``) but for its own attention."""
from perfbench.metrics_common import span_ms


def read(rec):
    return span_ms(rec, "train", rec.get("traced_steps"),
                   ["attn/core", "attn/core.bwd"], ["model/block"])
