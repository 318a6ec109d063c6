"""Served tokens a second: prompt and generated tokens of every request
the window completed, over the window's length to the end of its last
batch."""


def read(rec):
    if rec.get("kind") != "serve" or "window_s" not in rec or \
            not rec.get("requests"):
        return None
    return sum(p + n for p, n, _ in rec["requests"]) / rec["window_s"]
