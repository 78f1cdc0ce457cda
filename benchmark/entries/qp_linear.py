"""``aggforce_torch.qp.qp_linear_map`` with the configuration's bonded
pairs, then the map applied to the fit's frames."""

import torch


def prepare(system, cfg, device):
    import aggforce_torch as agg
    from aggforce_torch.qp import qplinear

    return {
        "agg": agg,
        "fit": qplinear.qp_linear_map,
        "routes": qplinear.fit_routes,
        "cmap": agg.LinearMap([[s] for s in system.sites], n_fg_sites=system.n_atoms),
        "pairs": {frozenset(p) for p in system.pairs},
        "l2": cfg.get("linear_l2_regularization", 0.0),
        "n_sites": len(system.sites),
        "device": device,
    }


def fit(state, coords, forces, rng):
    escalated = state["routes"]["escalated"]
    traj = state["agg"].Trajectory(coords=coords, forces=forces)
    with torch.profiler.record_function("bench.fit"):
        tmap = state["fit"](
            traj, state["cmap"], constraints=state["pairs"],
            l2_regularization=state["l2"], device=state["device"],
        )
    with torch.profiler.record_function("bench.apply"):
        mapped = tmap(traj).forces
    return {
        "mapped": mapped,
        "fmap": tmap.force_map.standard_matrix,
        "escalated_sites": state["n_sites"] * (state["routes"]["escalated"] - escalated),
    }
