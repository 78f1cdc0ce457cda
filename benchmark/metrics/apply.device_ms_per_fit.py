"""Device time a traced fit of the operations launched inside the
``aggforce.apply`` span (``FusedGBMap`` and ``TLinearMap`` applied to the
fit's frames), self time, in milliseconds."""

from benchmark.layers import per_fit


def read(run):
    return per_fit(run, "aggforce.apply", "layer_device_seconds", 1e3)
