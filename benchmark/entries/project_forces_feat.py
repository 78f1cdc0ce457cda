"""``aggforce_torch.project_forces`` with the canonical featurizer
(``Multifeaturize([id_feat, Curry(gb_feat, ...)])``), which takes the fused
featurized fit (kernel 1) and applies the map to the fit's frames."""

import torch


def prepare(system, cfg, device):
    import aggforce_torch as agg
    from aggforce_torch.qp.feat import gb_feat
    from aggforce_torch.qp.featlinearmap import Multifeaturize, id_feat
    from aggforce_torch.utils.funcs import Curry

    spec = cfg["featurizer"]
    gb = Curry(
        gb_feat, outer=spec["outer"], inner=spec["inner"], n_basis=spec["n_basis"],
        width=spec["width"], dist_power=spec["dist_power"],
    )
    return {
        "agg": agg,
        "cmap": agg.LinearMap([[s] for s in system.sites], n_fg_sites=system.n_atoms),
        "pairs": {frozenset(p) for p in system.pairs},
        "featurizer": Multifeaturize([id_feat, gb]),
        "kbt": system.kbt,
        "l2": cfg["l2_regularization"],
        "n_cf": cfg["n_constraint_frames"],
        "n_sites": len(system.sites),
        "device": device,
    }


def fit(state, coords, forces, rng):
    agg = state["agg"]
    with torch.profiler.record_function("bench.project_forces"):
        out = agg.project_forces(
            coords, forces, state["cmap"], constrained_inds=state["pairs"],
            method=agg.qp_feat_linear_map, featurizer=state["featurizer"],
            kbt=state["kbt"], l2_regularization=state["l2"],
            n_constraint_frames=state["n_cf"], constraint_rng=rng,
            device=state["device"],
        )
    tags = out["tmap"].force_map.tags
    return {
        "mapped": out["mapped_forces"],
        "coefs": tags["coef_list"],
        "escalated_sites": state["n_sites"] if tags["escalated"] else 0,
    }
