"""The linear fit with the configuration's constraints: the map and the
mapped forces against the float64 reference solve (``reference/linear.py``)."""

from benchmark import harness
from benchmark.reference import linear


def judge(ses, item, judged, precision="float64", share=None):
    coords, forces, frames, sites = harness.fit_inputs(ses, item, share)
    cfg, system = ses.cell.config, ses.system
    l2 = float(cfg.get("linear_l2_regularization", 0.0))
    fmap, mapped = (item["fmap"], item["mapped"]) if judged == "program" else (None, None)
    return linear.check_fit(forces, system.cmap_matrix(), system.pairs, l2, fmap, mapped, precision)


def work(shapes, t):
    """The linear Gram's 3T R (R + 1) flops, each unique entry once."""
    r = shapes["R"]
    return 3.0 * t * r * (r + 1)
