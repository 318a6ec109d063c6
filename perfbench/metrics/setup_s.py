"""Set-up seconds: process start to the window's start (imports, the
program's kernel builds or loads, weights from the seed, the first
steps or the warm-up batches)."""


def read(rec):
    return rec.get("setup_s")
