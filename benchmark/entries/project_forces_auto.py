"""``aggforce_torch.project_forces`` with every default: constraint
detection on the fit's coordinates, then ``qp_linear_map``, then the map
applied."""

import torch


def prepare(system, cfg, device):
    import aggforce_torch as agg
    from aggforce_torch.qp import qplinear

    return {
        "agg": agg,
        "routes": qplinear.fit_routes,
        "cmap": agg.LinearMap([[s] for s in system.sites], n_fg_sites=system.n_atoms),
        "n_sites": len(system.sites),
    }


def fit(state, coords, forces, rng):
    escalated = state["routes"]["escalated"]
    with torch.profiler.record_function("bench.project_forces"):
        out = state["agg"].project_forces(coords, forces, state["cmap"])
    return {
        "mapped": out["mapped_forces"],
        "fmap": out["tmap"].force_map.standard_matrix,
        "constraints": out["constraints"],
        "escalated_sites": state["n_sites"] * (state["routes"]["escalated"] - escalated),
    }
