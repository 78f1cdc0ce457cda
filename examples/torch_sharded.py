"""Multi-GPU force-map fitting over a torch.distributed mesh (the PyTorch port).

The port's twin of ``examples/sharded.py``. One process per device (SPMD):
every rank is handed the whole trajectory, uploads only its share of the
frame axis, reduces its Grams and takes part in one all-reduce; the small
solves run on every rank, and every rank returns the same maps:

  1. frame-sharded optimal linear map (``parallel.sharded_linear_fit``),
  2. frame-sharded fused featurized fit (``fused_gb_linear_map(mesh=...)``),
     the hand-written Gram kernel on each rank's frames on a card,
  3. frame-sharded single-pass cross validation (``fused_gb_cv(mesh=...)``).

On N cards of one host, with NCCL:

    torchrun --nproc-per-node N examples/torch_sharded.py

Two processes on the CPU over gloo (a file store in a temporary directory):

    python examples/torch_sharded.py --demo
"""

import argparse
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def worker(args) -> None:
    import numpy as np
    import torch.distributed as dist

    sys.path.insert(0, REPO)
    from aggforce_torch import LinearMap, Trajectory, force_smoothness
    from aggforce_torch.parallel import (
        initialize_distributed,
        make_mesh,
        sharded_linear_fit,
    )
    from aggforce_torch.qp import make_bond_constraint_matrix
    from aggforce_torch.qp.cv import fused_gb_cv
    from aggforce_torch.qp.fusedfeat import GBFeatSpec, fused_gb_linear_map
    from aggforce_torch.utils.synth import synthesize_trajectory

    # under torchrun the group comes from its environment; else from --store
    address = None if args.store is None else "file://" + args.store
    initialize_distributed(address, args.nproc, args.pid, backend=args.backend)
    mesh = make_mesh(device=args.device)
    rank0 = mesh.rank == 0
    if rank0:
        print(f"ranks: {mesh.size} ({dist.get_backend()}), mesh device of rank 0: "
              f"{mesh.device}", flush=True)

    rng = np.random.default_rng(0)
    base = rng.normal(scale=0.8, size=(args.atoms, 3))
    groups = [frozenset((i, i + 1)) for i in range(0, args.atoms // 3, 2)]
    coords, forces = synthesize_trajectory(base, groups, args.frames, seed=1)
    cmap = LinearMap(
        [[i] for i in range(0, args.atoms, max(1, args.atoms // 8))],
        n_fg_sites=args.atoms,
    )
    constraints = set(groups)

    # 1. frame-sharded optimal linear map
    t0 = time.perf_counter()
    fmat = sharded_linear_fit(
        forces, make_bond_constraint_matrix(args.atoms, constraints),
        cmap.standard_matrix, l2_regularization=1.0, mesh=mesh,
    )
    ortho = np.abs(cmap.standard_matrix @ fmat.T - np.eye(cmap.n_cg_sites)).max()
    if not ortho <= 1e-3:
        raise SystemExit(f"orthogonality error {ortho:.2e}")
    if rank0:
        print(f"sharded linear fit: {time.perf_counter() - t0:.2f} s, orthogonality "
              f"max err {ortho:.1e}", flush=True)

    # 2. frame-sharded fused featurized fit
    spec = GBFeatSpec(outer=3.0, n_basis=5)
    t0 = time.perf_counter()
    tmap = fused_gb_linear_map(
        Trajectory(coords=coords, forces=forces), cmap, kbt=1.0, spec=spec,
        constraints=constraints, l2_regularization=1e2,
        constraint_rng=np.random.default_rng(3), mesh=mesh,
    )
    _, mf = tmap.map_arrays(coords[:256], forces[:256])
    if rank0:
        print(f"sharded featurized fit: {time.perf_counter() - t0:.2f} s, residual "
              f"{force_smoothness(mf):.4f}", flush=True)

    # 3. frame-sharded single-pass CV over an l2 grid
    t0 = time.perf_counter()
    table = fused_gb_cv(
        coords, forces, cmap, constraints, kbt=1.0, spec=spec,
        l2_values=[1e0, 1e2, 1e4], n_folds=3, rng=np.random.default_rng(5), mesh=mesh,
    )
    if rank0:
        best = min(table, key=lambda k: table[k][0])
        print(f"sharded CV ({len(table)} l2 x 3 folds): {time.perf_counter() - t0:.2f} s, "
              f"best l2 {best:g}", flush=True)
        for l2, (mean, sd, n) in sorted(table.items()):
            print(f"  l2={l2:<8g} holdout={mean:.4f} sd={sd:.4f} n={n}", flush=True)
        print("sharded demo OK", flush=True)
    dist.destroy_process_group()


def demo(args) -> None:
    """Two gloo processes on the CPU, joined through a file store."""
    store = os.path.join(tempfile.mkdtemp(prefix="aggforce_sharded_"), "store")
    # a share of the cores each (unless the caller set one): two CPU
    # processes both using every core spend their time waiting on each
    # other's threads
    threads = os.environ.get("OMP_NUM_THREADS") or str(max(1, (os.cpu_count() or 2) // 2))
    env = dict(os.environ, OMP_NUM_THREADS=threads)
    procs = [
        subprocess.Popen([
            sys.executable, os.path.abspath(__file__), "--store", store, "--nproc", "2",
            "--pid", str(pid), "--backend", "gloo", "--device", "cpu",
            "--frames", str(args.frames), "--atoms", str(args.atoms),
        ], env=env)
        for pid in range(2)
    ]
    try:
        codes = [p.wait(timeout=600) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    if any(codes):
        raise SystemExit(f"demo workers failed: {codes}")


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--demo", action="store_true")
    parser.add_argument("--frames", type=int, default=2000)
    parser.add_argument("--atoms", type=int, default=60)
    parser.add_argument("--store", default=None, help="file store path shared by the ranks")
    parser.add_argument("--nproc", type=int, default=None)
    parser.add_argument("--pid", type=int, default=None)
    parser.add_argument("--backend", default=None, help="nccl or gloo (default: by device)")
    parser.add_argument("--device", default=None, help="default: this rank's CUDA card")
    args = parser.parse_args()
    if args.demo:
        demo(args)
    else:
        worker(args)


if __name__ == "__main__":
    main()
