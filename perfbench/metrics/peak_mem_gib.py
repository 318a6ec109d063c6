"""The device memory the window allocated at its peak, in GiB
(``torch.cuda.max_memory_allocated`` after a reset at its start)."""


def read(rec):
    b = rec.get("peak_bytes")
    return None if b is None else b / float(1 << 30)
