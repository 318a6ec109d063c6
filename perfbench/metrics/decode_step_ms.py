"""The mean synchronized host time of a ``decode_step`` over every
traced decode step, in ms."""


def read(rec):
    walls = rec.get("decode_s")
    if rec.get("kind") != "serve" or not walls:
        return None
    return 1e3 * sum(walls) / len(walls)
