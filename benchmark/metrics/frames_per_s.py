"""Frames of all fits completed in the window over the window's wall time
(from its start to the end of the last fit), host clock."""


def read(run):
    if run.window_s <= 0 or not run.fit_seconds:
        return None
    return len(run.fit_seconds) * run.frames_per_fit / run.window_s
