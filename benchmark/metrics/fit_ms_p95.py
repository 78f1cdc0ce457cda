"""95th percentile of the window's fit times (call to mapped forces in hand,
after ``torch.cuda.synchronize()``), host clock, in milliseconds."""

import numpy as np


def read(run):
    if not run.fit_seconds:
        return None
    return 1e3 * float(np.percentile(run.fit_seconds, 95))
