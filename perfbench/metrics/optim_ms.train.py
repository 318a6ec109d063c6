"""Device ms a traced training step of the events launched inside the
program's spans ``train/clip`` and ``train/adamw`` (the global-norm clip,
the schedule and the update)."""
from perfbench.metrics_common import span_ms


def read(rec):
    return span_ms(rec, "train", rec.get("traced_steps"),
                   ["train/clip", "train/adamw"])
