"""``aggforce_torch.qp.fused_gb_linear_map_blocked`` over a mesh of ranks,
one process per card: every rank fits the whole window, the ranks split
the site blocks, and one all-gather gives each rank every site's
coefficients. Then each rank maps its own contiguous share of the frames
in slices of ``blocked_feat.APPLY_SLICE`` (the map's own 4,096-frame chunk
runs out of memory at this width), and the shares are gathered over the
mesh, so that every rank holds the window's mapped forces for the check.

``prepare`` joins the program's own process group as a user's run does
(``parallel.initialize_distributed(url, world, rank)``, then
``make_mesh``); NCCL on the cards, gloo on the CPU."""

import torch

from benchmark.entries import blocked_feat


def prepare(system, cfg, device, rank, world, init_url):
    from aggforce_torch import parallel

    backend = "nccl" if device.type == "cuda" else "gloo"
    parallel.initialize_distributed(init_url, world, rank, backend=backend)
    state = blocked_feat.prepare(system, cfg, device)
    state["mesh"] = parallel.make_mesh(device=device)
    return state


def fit(state, coords, forces, rng):
    mesh = state["mesh"]
    traj = state["agg"].Trajectory(coords=coords, forces=forces)
    with torch.profiler.record_function("bench.fit"):
        tmap = state["fit"](
            traj, state["cmap"], kbt=state["kbt"], spec=state["spec"],
            constraints=state["pairs"], n_constraint_frames=state["n_cf"],
            l2_regularization=state["l2"], chunk_size=state["chunk_size"],
            constraint_rng=rng, site_block=state["site_block"],
            mesh=mesh, device=state["device"],
        )
    t = coords.shape[0]
    per = -(-t // mesh.size)
    lo, hi = min(t, mesh.rank * per), min(t, (mesh.rank + 1) * per)
    step = blocked_feat.APPLY_SLICE
    with torch.profiler.record_function("bench.apply"):
        parts = [tmap(traj[a : min(a + step, hi)]).forces for a in range(lo, hi, step)]
        n_sites = len(tmap.force_map.tags["coef_list"])
        mine = coords.new_zeros((per, n_sites, 3))
        if parts:
            mine[: hi - lo] = torch.cat(parts)
    with torch.profiler.record_function("bench.gather"):
        mapped = mesh.all_gather(mine)[:t]
    tags = tmap.force_map.tags
    return {
        "mapped": mapped,
        "coefs": tags["coef_list"],
        "escalated_sites": int(tags["escalated"]),
    }
