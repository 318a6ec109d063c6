"""The 95th percentile (nearest rank) of the time to first token over
every request the window completed, in ms: from when its batch was due
to when the host held its first token."""
from perfbench.common import p_nearest


def read(rec):
    if rec.get("kind") != "serve" or "window_s" not in rec or \
            not rec.get("requests"):
        return None
    return 1e3 * p_nearest([t for _, _, t in rec["requests"]], 0.95)
