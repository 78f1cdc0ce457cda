"""Gaussian (noised) force maps with the PyTorch port.

The port's twin of ``examples/gauss.py``: builds each of the four Gaussian
map variants, compares their in-sample force residuals against the
deterministic optimal linear map, and demonstrates the staged save/load
workflow (serialize the fitted map, reload, keep mapping). No hand-written
kernel runs here: the Gaussian maps are linear fits on augmented arrays.

The system is a CLN025-style fixture of ``--pdb`` with its C-alpha map (the
JAX example's system), or without ``--pdb`` the JAX bench's standalone
system (bench.py:290-307). Both are made from seed 11.

Run on the card, or on the CPU:

    python examples/torch_gauss.py [--frames 2000] [--pdb cln025.pdb]
    python examples/torch_gauss.py --device cpu --frames 200
"""

import argparse
import os
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 11


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--frames", type=int, default=2000)
    parser.add_argument("--pdb", default=None, help="topology PDB (default: standalone)")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    sys.path.insert(0, REPO)
    from aggforce_torch import (
        Trajectory,
        joptgauss_map,
        project_forces,
        stagedjforcegauss_map,
        stagedjoptgauss_map,
        stagedjslicegauss_map,
    )
    from aggforce_torch.agg import RESIDUAL_KNAME, TMAP_KNAME
    from aggforce_torch.utils.device import resolve_device
    from aggforce_torch.utils.prof import PhaseTimer
    from aggforce_torch.utils.serialize import load_tmap, save_tmap
    from aggforce_torch.utils.synth import example_system

    device = resolve_device(args.device)
    try:
        fix, cmap, label = example_system(args.frames, SEED, args.pdb)
    except FileNotFoundError as err:
        raise SystemExit(str(err)) from None
    print(f"system: {label}", flush=True)
    coords, forces, kbt = fix["coords"], fix["forces"], float(fix["kbt"])
    constraints = set(fix["constraint_groups"])

    timer = PhaseTimer()
    results = {}
    with timer.phase("optimal linear (baseline)"):
        results["linear"] = project_forces(
            coords=coords, forces=forces, coord_map=cmap,
            constrained_inds=constraints, device=device,
        )
    for name, method in [
        ("joptgauss", joptgauss_map),
        ("stagedjoptgauss", stagedjoptgauss_map),
        ("stagedjslicegauss", stagedjslicegauss_map),
        ("stagedjforcegauss", stagedjforcegauss_map),
    ]:
        with timer.phase(name):
            results[name] = project_forces(
                coords=coords, forces=forces, coord_map=cmap,
                constrained_inds=constraints, method=method,
                var=0.002, kbt=kbt, seed=42, device=device,
            )

    # the slice map's residual comes back as float64, the others as float32
    # (in the JAX package too): print and return them all as Python floats
    residuals = {name: float(res[RESIDUAL_KNAME]) for name, res in results.items()}
    print("\nin-sample force residuals (mean squared mapped force):")
    for name, value in residuals.items():
        print(f"  {name:<20s} {value:12.4f}")

    # staged workflow: map with the deterministic premap now, noise later
    staged = results["stagedjoptgauss"][TMAP_KNAME]
    premapped = staged[1](Trajectory(coords=coords, forces=forces))
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "staged_map.npz")
        save_tmap(path, staged)
        reloaded = load_tmap(path, device=device)
        final = reloaded[0](premapped)
    print(
        f"\nstaged save/load OK: premapped {tuple(premapped.coords.shape)} -> "
        f"noised {tuple(final.coords.shape)}"
    )
    print("\n" + timer.report(), flush=True)
    return {
        "system": label,
        "coords": coords,
        "forces": forces,
        "coord_map": cmap,
        "constraints": constraints,
        "residuals": residuals,
        "staged_map": staged,
        "reloaded_map": reloaded,
        "premapped_shape": tuple(premapped.coords.shape),
        "noised_shape": tuple(final.coords.shape),
        "phase_s": {name: timer.total(name) for name, _ in timer.records},
    }


if __name__ == "__main__":
    main()
