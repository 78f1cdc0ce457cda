"""Bootstrap uncertainty for a featurized force map via batched fits, with
the PyTorch port.

The port's twin of ``examples/bootstrap.py``. The featurized fit enforces
orthogonality on a random subsample of frames (``n_constraint_frames``), so
the fitted coefficients carry sampling noise. This example quantifies it:
fit B maps, one per constraint-frame seed, with
:func:`fused_gb_linear_map_batch`. Every window of fits shares ONE
trajectory Gram (the hand-written Gram kernel, one launch per window on a
card) and one per-site factorization.

Reported: the spread of the per-fit solver residuals, the coefficient
standard deviation (relative to the mean coefficient magnitude), and the
spread of the physical observable, the mean squared mapped force.

Data: ``--data`` names an npz with ``coords`` and ``Fs`` (the upstream
water-dimer layout). By default it is the water-dimer fixture in the
repository's ``tests/data``; while that file is absent the example fits
``synthesize_dimer_fixture()`` instead and says so. A ``--data`` given
explicitly must exist.

Run on the card, or on the CPU:

    python examples/torch_bootstrap.py [--n-maps 32] [--window 16] [--data dimer.npz]
    python examples/torch_bootstrap.py --device cpu --n-maps 4 --window 2
"""

import argparse
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--n-maps", type=int, default=32)
    ap.add_argument("--window", type=int, default=16)
    ap.add_argument("--data", default=None, help="npz with coords and Fs")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    sys.path.insert(0, REPO)
    import numpy as np
    import torch

    from aggforce_torch import LinearMap
    from aggforce_torch.qp.fusedfeat import GBFeatSpec, fused_gb_linear_map_batch
    from aggforce_torch.trajectory import Trajectory
    from aggforce_torch.utils.device import resolve_device
    from aggforce_torch.utils.synth import (
        WATERDIMER,
        reference_waterdimer,
        synthesize_dimer_fixture,
    )

    device = resolve_device(args.device)
    raw = reference_waterdimer(args.data or WATERDIMER)
    if raw is not None:
        source = args.data or WATERDIMER
    elif args.data is not None:
        raise SystemExit(f"missing data file: {args.data}")
    else:
        raw = synthesize_dimer_fixture()
        source = "synthesize_dimer_fixture() (the water-dimer fixture is absent)"
    coords, forces = raw["coords"], raw["forces"]
    print(f"data: {source}, {coords.shape[0]} frames x {coords.shape[1]} atoms", flush=True)
    cmap = LinearMap([[0], [3]], n_fg_sites=coords.shape[1])
    # device-resident trajectory: every fit stays on the device end to end
    traj = Trajectory(
        coords=torch.as_tensor(coords, device=device),
        forces=torch.as_tensor(forces, device=device),
    )
    spec = GBFeatSpec(outer=1.0, inner=0.0, n_basis=5, width=1.0)

    t0 = time.perf_counter()
    maps = fused_gb_linear_map_batch(
        traj,
        cmap,
        kbt=0.6955215,
        spec=spec,
        seeds=range(args.n_maps),
        constraints=set(),
        l2_regularization=1e1,
        chunk_size=256,
        flush_every=args.window,
    )
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0
    print(
        f"fitted {len(maps)} maps in {wall:.3f}s "
        f"({wall / len(maps) * 1e3:.1f} ms/map, {args.window}-fit windows)"
    )

    resids = np.array([m.force_map.tags["solver_resid"] for m in maps])
    coefs = np.stack(
        [np.asarray(m.force_map.tags["coef_list"]) for m in maps]
    )  # (B, S, K)
    rel_spread = float(coefs.std(axis=0).mean() / np.abs(coefs).mean())
    print(
        f"solver residuals: min {resids.min():.2e} / "
        f"median {np.median(resids):.2e} / max {resids.max():.2e}"
    )
    print(f"coefficient spread (std/|mean|): {rel_spread:.3f}")

    # physical observable: mean squared mapped force per bootstrap map
    msf = []
    for m in maps:
        _, mf = m.map_arrays(coords, forces)
        msf.append(float(np.mean(np.asarray(mf) ** 2)))
    msf = np.array(msf)
    print(
        f"mean squared mapped force: {msf.mean():.4f} "
        f"+/- {msf.std():.4f} across {len(maps)} constraint-frame samples",
        flush=True,
    )
    return {
        "source": source,
        "seconds": wall,
        "resids": resids,
        "coef_spread": rel_spread,
        "msf": msf,
        "maps": maps,
        "coord_map": cmap,
        "coords": coords,
        "forces": forces,
    }


if __name__ == "__main__":
    main()
