"""The featurized fit: each checked site's coefficients and mapped forces
against the float64 reference fit (``reference/featurized.py``)."""

from benchmark import harness
from benchmark.reference import featurized


def judge(ses, item, judged, precision="float64", share=None):
    coords, forces, frames, sites = harness.fit_inputs(ses, item, share)
    prog = judged == "program"
    coefs = featurized.coefs_from_program(item["coefs"], coords.device) if prog else None
    return featurized.check_fit(
        ses.system, ses.cell.config, coords, forces, frames, sites, coefs,
        item["mapped"] if prog else None, precision,
    )


def work(shapes, t):
    """The per-site Grams' 3T S K_exp (K_exp + 1) flops, each unique entry once."""
    k = shapes["K_exp"]
    return 3.0 * t * shapes["S"] * k * (k + 1)
