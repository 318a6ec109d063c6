"""The device's idle share over the traced training steps: 1 - (union of
kernel, copy and memset intervals) / window, in %."""
from perfbench.metrics_common import idle_share


def read(rec):
    return idle_share(rec, "train")
