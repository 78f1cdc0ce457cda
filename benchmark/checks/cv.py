"""The cross-validated study: the program's table of mean holdout scores,
their fold sds and the static-map control's score against the float64
reference study, every fold refitted (``reference/cv.py``).

Scores and sds are judged one l2 value at a time
(``score_rel_err.l2_<l2>``, ``sd_rel_err.l2_<l2>``: the largest relative
error over the grid's featurizers at that l2), at the l2 values of
:data:`SCORE_ROWS` and :data:`SD_ROWS`. The float32 design rows' rounding
reaches a score amplified by the train system's conditioning, which the l2
value sets: a limit that holds at l2 = 1e1 would pass any fault at 1e4. At
l2 = 1e4 the program, at the float32 rows' floor, and the TF32 control
overlap within 1.3x, and the fold sds, small differences of fold scores,
read no better in the program than in the control at l2 = 1e2 and 1e3 and
within 1.6x of it at 1e4 (``benchmark/limits/cln025_ca_cv.study.json``
keeps those readings): no limit separates the two there with room, so they
are not judged."""

import numpy as np

from benchmark import harness
from benchmark.reference import cv

# the configuration whose grid ``work`` counts
CONFIG = harness.BENCH_DIR / "configs" / "cln025_ca_cv.json"
# what a value that is not finite (a score not computed) reads: beyond every
# limit, and still a number in the result's JSON
NOT_FINITE = 1e300


# the l2 values whose scores, and whose fold sds, are judged (see the
# module's note)
SCORE_ROWS = (1e1, 1e2, 1e3)
SD_ROWS = (1e1,)


def _rel_err(got, ref) -> np.ndarray:
    """|got - ref| / |ref| elementwise; NOT_FINITE where it is not finite."""
    err = np.abs(np.asarray(got, dtype=np.float64) - ref) / np.abs(ref)
    return np.where(np.isfinite(err), err, NOT_FINITE)


def judge(ses, item, judged, precision="float64", share=None):
    coords, forces, _, _ = harness.fit_inputs(ses, item, share)
    cfg = ses.cell.config

    def run(p):
        rng = harness._stream(ses.seed, harness._FIT, item["i"])
        return cv.study(ses.system, cfg, coords, forces, rng, p)

    ref = run("float64")
    got = item if judged == "program" else run(precision)
    scores = np.asarray(got["scores"], dtype=np.float64)
    err = _rel_err(scores, ref["scores"])
    sd_err = _rel_err(np.asarray(got["sds"], dtype=np.float64), ref["sds"])
    l2s = [float(v) for v in cfg["l2_regularization"]]
    out = {f"score_rel_err.l2_{l2:g}": float(err[:, l2s.index(l2)].max()) for l2 in SCORE_ROWS}
    out.update({f"sd_rel_err.l2_{l2:g}": float(sd_err[:, l2s.index(l2)].max()) for l2 in SD_ROWS})
    out["control_rel_err"] = float(_rel_err(got["control"], ref["control"]))
    best = np.unravel_index(np.argmin(np.where(np.isfinite(scores), scores, np.inf)), scores.shape)
    out["best_regret"] = float(ref["scores"][best] / ref["scores"].min() - 1.0)
    return out


def grid_ks(shapes):
    """K_exp = G (1 + n_basis) of each grid point, in the grid's order."""
    cfg = harness.load_json(CONFIG)
    return [shapes["G"] * (1 + int(p["n_basis"])) for p in cv.grid_points(cfg)]


def work(shapes, t):
    """The fold Grams' flops over the grid: each featurizer's held-out
    Grams cover the window's t frames once, 3t S K_exp (K_exp + 1) with
    each unique entry once, K_exp = G (1 + n_basis) of the grid point."""
    return sum(3.0 * t * shapes["S"] * k * (k + 1) for k in grid_ks(shapes))
