"""The linear fit with detected constraints: the detected pairs against
float64 detection (``reference/detect.py``; ``mismatched_pairs``), then the
map and the mapped forces against the float64 reference solve with the
reference's pairs (``reference/linear.py``)."""

from benchmark import harness
from benchmark.checks.linear import work  # noqa: F401 (the same Gram)
from benchmark.reference import detect, linear


def judge(ses, item, judged, precision="float64", share=None):
    coords, forces, frames, sites = harness.fit_inputs(ses, item, share)
    cfg, system = ses.cell.config, ses.system
    l2 = float(cfg.get("linear_l2_regularization", 0.0))
    prog = judged == "program"
    fmap, mapped = (item["fmap"], item["mapped"]) if prog else (None, None)
    ref_pairs = detect.detect(coords, "float64")
    found = {tuple(sorted(p)) for p in item["constraints"]} if prog else detect.detect(coords, precision)
    out = {"mismatched_pairs": float(len(found ^ ref_pairs))}
    out.update(linear.check_fit(forces, system.cmap_matrix(), sorted(ref_pairs), l2, fmap, mapped, precision))
    return out
