"""Kernels a traced fit launched inside the ``aggforce.detect`` span
(``constraints.finder.guess_pairwise_constraints``, every detection
chunk)."""

from benchmark.layers import per_fit


def read(run):
    return per_fit(run, "aggforce.detect", "layer_launches")
