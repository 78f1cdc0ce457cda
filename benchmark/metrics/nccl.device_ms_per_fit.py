"""Device time of the NCCL kernels on rank 0 (names that contain ``nccl``,
any case) in a traced fit, in milliseconds: the median over the traced fits,
so that one fit in which rank 0 waited long for a slow rank does not set
the reading. A kernel belongs to the fit whose ``bench.fit`` span (the
entry's) is the last to start before it; each fit ends with its card
synchronized, so no kernel of one fit runs in the next. The time holds the
exchange between the cards and the wait in it for the slowest rank, which
rank 0's trace alone cannot tell apart."""

import bisect
import re
import statistics

PATTERNS = (r"(?i)nccl",)
FIT_SPAN = "bench.fit"


def read(run):
    if run.trace is None or not run.fit_seconds:
        return None
    w0, w1 = run.trace.window
    starts = sorted(s for name, s, _ in run.trace.spans if name == FIT_SPAN and w0 <= s < w1)
    if not starts:
        return None
    per_fit = [0.0] * len(starts)
    hit = False
    for name, s, e in run.trace.device_ops:
        k = bisect.bisect_right(starts, s) - 1
        if k >= 0 and e > w0 and s < w1 and any(re.search(p, name) for p in PATTERNS):
            per_fit[k] += min(e, w1) - max(s, w0)
            hit = True
    return 1e3 * statistics.median(per_fit) if hit else None
