"""The whole fit's share of the chips' peak: the fits' Gram work, as the
cell's check counts it (``work`` of ``benchmark/checks/<check>.py``: the
featurized Gram's 3T S K_exp (K_exp + 1) flops, or the linear Gram's
3T R (R + 1), each unique entry once), at the TF32 peak of every chip the
cell runs on, over the traced window's wall time (rank 0's, which ends with
the slowest rank's last fit). Everything else a fit does (constraint rows,
solve, apply, detection, the exchange between chips) counts as time but not
as work, so the share bounds every kernel's gain from above: a change that
takes a kernel off the path leaves its roofline silent, and this share
still moves."""

from benchmark.peaks import TF32_FLOPS


def read(run):
    if run.trace is None or not run.fit_seconds or run.trace.window_s <= 0:
        return None
    work = len(run.fit_seconds) * run.cell.check.work(run.shapes, run.frames_per_fit)
    return 100.0 * work / (TF32_FLOPS * run.cell.chips) / run.trace.window_s
