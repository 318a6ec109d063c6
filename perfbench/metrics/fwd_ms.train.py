"""Device ms a traced training step of the events launched inside the
program's span ``train/forward`` (the loss)."""
from perfbench.metrics_common import span_ms


def read(rec):
    return span_ms(rec, "train", rec.get("traced_steps"),
                   ["train/forward"])
