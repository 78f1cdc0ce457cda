"""``aggforce_torch.qp.fused_gb_linear_map_blocked``, the site-blocked
featurized fit (kernel 2), then the map applied to the fit's frames in
slices of ``APPLY_SLICE``: the map's own 4,096-frame apply chunk takes ~24
GiB per temporary at 66 sites x 1,125 groups x 7 basis functions and runs
out of the card's memory on a 20,000-frame window."""

import torch

APPLY_SLICE = 2048


def prepare(system, cfg, device):
    import aggforce_torch as agg
    from aggforce_torch.qp import fused_gb_linear_map_blocked
    from aggforce_torch.qp.fusedfeat import GBFeatSpec

    spec = cfg["featurizer"]
    return {
        "agg": agg,
        "fit": fused_gb_linear_map_blocked,
        "cmap": agg.LinearMap([[s] for s in system.sites], n_fg_sites=system.n_atoms),
        "pairs": {frozenset(p) for p in system.pairs},
        "spec": GBFeatSpec(
            outer=spec["outer"], inner=spec["inner"], n_basis=spec["n_basis"],
            width=spec["width"], dist_power=spec["dist_power"], clip=spec["clip"],
        ),
        "kbt": system.kbt,
        "l2": cfg["l2_regularization"],
        "n_cf": cfg["n_constraint_frames"],
        "chunk_size": cfg["chunk_size"],
        "site_block": cfg["site_block"],
        "device": device,
    }


def fit(state, coords, forces, rng):
    traj = state["agg"].Trajectory(coords=coords, forces=forces)
    with torch.profiler.record_function("bench.fit"):
        tmap = state["fit"](
            traj, state["cmap"], kbt=state["kbt"], spec=state["spec"],
            constraints=state["pairs"], n_constraint_frames=state["n_cf"],
            l2_regularization=state["l2"], chunk_size=state["chunk_size"],
            constraint_rng=rng, site_block=state["site_block"],
            device=state["device"],
        )
    with torch.profiler.record_function("bench.apply"):
        mapped = torch.cat(
            [
                tmap(traj[lo : lo + APPLY_SLICE]).forces
                for lo in range(0, coords.shape[0], APPLY_SLICE)
            ]
        )
    tags = tmap.force_map.tags
    return {
        "mapped": mapped,
        "coefs": tags["coef_list"],
        "escalated_sites": int(tags["escalated"]),
    }
