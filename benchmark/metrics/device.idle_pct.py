"""Share of the traced window in which no kernel, copy or fill ran on the
device: 1 minus the union of their intervals over the window's wall time."""


def read(run):
    if run.trace is None or run.trace.window_s <= 0 or not run.trace.device_ops:
        return None
    return 100.0 * (1.0 - run.trace.busy_s() / run.trace.window_s)
