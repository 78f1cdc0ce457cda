"""A cross-validated hyperparameter study, as upstream ``examples/cv_feat.py``
runs it, through ``aggforce_torch.agg.project_forces_grid_cv``:

1. constraints detected on the window's first ``detect_frames`` frames;
2. the static linear map's k-fold CV at the control's l2 (the baseline);
3. the k-fold CV of ``Multifeaturize([id_feat, Curry(gb_feat, ...)])`` over
   the configuration's featurizer grid crossed with its l2 values.

Both CV calls pass ``fast=True``, so a grid that would fall back to the
refit loop raises instead of timing another path, and each takes its own
generator, one of two spawned from the study's (``Generator.spawn``). Returns
the (featurizers, l2) tables of mean holdout scores and their sample sds in
the grid's order, the control's score and, as ``escalated_sites``, the
(l2, fold) cells that the float64 host oracle redid during the study.
"""

from itertools import product

import numpy as np
import torch


def grid_points(cfg):
    """The featurizer of each grid point, in ``gen_feater_grid``'s order:
    the base arguments with the grid's keys overridden."""
    grid = cfg["grid"]
    keys = list(grid)
    return [dict(cfg["featurizer"], **dict(zip(keys, values))) for values in product(*grid.values())]


def prepare(system, cfg, device):
    import aggforce_torch as agg
    from aggforce_torch.agg import NRUNS_KNAME, SCORES_KNAME, SDS_KNAME
    from aggforce_torch.constraints import guess_pairwise_constraints
    from aggforce_torch.qp.feat import gb_feat
    from aggforce_torch.qp.featlinearmap import Multifeaturize, id_feat, qp_feat_linear_map
    from aggforce_torch.qp.qplinear import fit_routes
    from aggforce_torch.utils.funcs import Curry

    feats = [
        Multifeaturize([id_feat, Curry(
            gb_feat, outer=p["outer"], inner=p["inner"], n_basis=p["n_basis"],
            width=p["width"], dist_power=p["dist_power"],
        )])
        for p in grid_points(cfg)
    ]
    return {
        "grid_cv": agg.project_forces_grid_cv,
        "detect": guess_pairwise_constraints,
        "method": qp_feat_linear_map,
        "keys": (SCORES_KNAME, SDS_KNAME, NRUNS_KNAME),
        "routes": fit_routes,
        "cmap": agg.LinearMap([[s] for s in system.sites], n_fg_sites=system.n_atoms),
        "feats": feats,
        "l2": [float(v) for v in cfg["l2_regularization"]],
        "control_l2": float(cfg["control_l2_regularization"]),
        "n_folds": int(cfg["n_folds"]),
        "n_cf": int(cfg["n_constraint_frames"]),
        "detect_frames": int(cfg["detect_frames"]),
        "threshold": float(cfg["detect_threshold"]),
        "kbt": system.kbt,
        "device": device,
    }


def fit(state, coords, forces, rng):
    escalated = state["routes"]["cv_escalated_cells"]
    control_rng, grid_rng = rng.spawn(2)
    scores_key, sds_key, runs_key = state["keys"]
    common = dict(
        coords=coords, forces=forces, n_folds=state["n_folds"], fast=True,
        coord_map=state["cmap"], device=state["device"],
    )
    with torch.profiler.record_function("bench.detect"):
        constraints = state["detect"](
            coords[: state["detect_frames"]], threshold=state["threshold"], device=state["device"],
        )
    with torch.profiler.record_function("bench.control"):
        control = state["grid_cv"](
            {"l2_regularization": [state["control_l2"]]}, rng=control_rng,
            constrained_inds=constraints, **common,
        )
    with torch.profiler.record_function("bench.grid"):
        results = state["grid_cv"](
            {"featurizer": state["feats"], "l2_regularization": state["l2"]}, rng=grid_rng,
            constrained_inds=constraints, method=state["method"], kbt=state["kbt"],
            n_constraint_frames=state["n_cf"], **common,
        )
    index = {id(f): i for i, f in enumerate(state["feats"])}
    shape = (len(state["feats"]), len(state["l2"]))
    scores, sds, runs = np.full(shape, np.nan), np.full(shape, np.nan), np.zeros(shape, dtype=int)
    for label, score in results[scores_key].items():
        at = (index[id(label.featurizer)], state["l2"].index(float(label.l2_regularization)))
        scores[at] = np.nan if score is None else score
        sd = results[sds_key][label]
        sds[at] = np.nan if sd is None else sd
        runs[at] = results[runs_key][label]
    return {
        "scores": scores,
        "sds": sds,
        "runs": runs,
        "control": float(next(iter(control[scores_key].values()))),
        "constraints": constraints,
        "escalated_sites": state["routes"]["cv_escalated_cells"] - escalated,
    }
