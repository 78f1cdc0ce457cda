"""Sites per fit whose float32 solve went to the float64 host solver: the
fitted maps' ``tags["escalated"]`` (a flag for the whole fit on the unblocked
path, so every site; a count on the blocked path), over the traced fits."""


def read(run):
    if not run.escalated:
        return None
    return sum(run.escalated) / len(run.escalated)
