"""Training tokens a second: B x S of every step the window started,
over the time from its start to the synchronized end of its last step."""


def read(rec):
    if rec.get("kind") != "train" or not rec.get("steps"):
        return None
    return rec["steps"] * rec["tokens_per_step"] / rec["window_s"]
