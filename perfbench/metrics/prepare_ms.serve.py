"""Device ms a traced batch of the events launched inside the program's
spans ``model/prepare`` (the weights' cast a ``generate``) and
``serve/pad_caches`` (the caches grown to their length)."""
from perfbench.metrics_common import span_ms


def read(rec):
    return span_ms(rec, "serve", len(rec.get("prefills") or ()),
                   ["model/prepare", "serve/pad_caches"])
