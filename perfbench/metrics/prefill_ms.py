"""The mean synchronized host time of a ``prefill_step`` over every
traced prefill (all prompt lengths), in ms."""


def read(rec):
    walls = rec.get("prefill_s")
    if rec.get("kind") != "serve" or not walls:
        return None
    return 1e3 * sum(walls) / len(walls)
