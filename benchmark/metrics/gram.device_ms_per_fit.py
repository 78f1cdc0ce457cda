"""Device time a traced fit of the operations launched inside the
``aggforce.gram`` span: the whole Gram layer (packing, kernel 1 or 2 or
the linear Gram's SGEMM, its transposing copy and ``index_add_``,
unpacking), self time, in milliseconds."""

from benchmark.layers import per_fit


def read(run):
    return per_fit(run, "aggforce.gram", "layer_device_seconds", 1e3)
