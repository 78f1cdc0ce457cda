"""Host calls that wait for the card (stream, device and event
synchronizations, synchronous copies) started inside the ``aggforce.solve``
span, a traced fit."""

from benchmark.layers import per_fit


def read(run):
    return per_fit(run, "aggforce.solve", "layer_syncs")
