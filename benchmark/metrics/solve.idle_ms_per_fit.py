"""Device-idle time a traced fit while the host was inside the
``aggforce.solve`` span and none of its children (the host-blocking steps
of the solve: shift checks, host syncs, host-side linear algebra), in
milliseconds."""

from benchmark.layers import per_fit


def read(run):
    return per_fit(run, "aggforce.solve", "layer_idle_seconds", 1e3)
