"""Device time a traced fit of the operations launched inside the
``aggforce.solve`` span (the ``ops.eqp`` solvers and the linear fit's
``_solve_linear_gram``: factor, Schur stage, refinement), self time, the
union of their intervals in the window, in milliseconds."""

from benchmark.layers import per_fit


def read(run):
    return per_fit(run, "aggforce.solve", "layer_device_seconds", 1e3)
