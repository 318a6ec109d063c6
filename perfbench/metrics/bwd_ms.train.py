"""Device ms a traced training step of the events launched inside the
program's span ``train/backward`` (the backward pass, with the blocks
recomputed in it)."""
from perfbench.metrics_common import span_ms


def read(rec):
    return span_ms(rec, "train", rec.get("traced_steps"),
                   ["train/backward"])
