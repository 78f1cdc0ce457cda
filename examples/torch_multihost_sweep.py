"""Multi-process streamed sweep with the PyTorch port: one script for every rank.

The port's twin of ``examples/multihost_sweep.py``. Each process
memory-maps the shared trajectory files, streams ONLY its own frame slice
(``parallel.process_frame_slice``) chunk by chunk through its device (the
hand-written Gram kernel once per chunk on a card), and one all-reduce
merges the per-rank Grams at the finish. Every process ends up with the
same fitted map: the constraint frames are rank 0's draw.

One process per card, across hosts or on one (NCCL):

    torchrun --nnodes H --nproc-per-node N ... examples/torch_multihost_sweep.py \\
        --coords c.npy --forces f.npy

or demo the whole flow locally with two CPU processes over gloo:

    python examples/torch_multihost_sweep.py --demo
"""

import argparse
import os
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def worker(args) -> None:
    import numpy as np
    import torch.distributed as dist

    sys.path.insert(0, REPO)
    from aggforce_torch import LinearMap
    from aggforce_torch.io import TrajectoryStream, fused_gb_linear_map_streamed
    from aggforce_torch.parallel import (
        global_frame_mesh,
        initialize_distributed,
        process_frame_slice,
    )
    from aggforce_torch.qp.fusedfeat import GBFeatSpec

    address = None if args.store is None else "file://" + args.store
    initialize_distributed(address, args.nproc, args.pid, backend=args.backend)
    mesh = global_frame_mesh(device=args.device)
    stream = TrajectoryStream.from_npy(args.coords, args.forces, chunk_size=args.chunk_size)
    sl = process_frame_slice(stream.n_frames)
    print(f"rank {mesh.rank}/{mesh.size}: frames [{sl.start}, {sl.stop}) on {mesh.device}",
          flush=True)
    cmap = LinearMap(
        [[i] for i in range(0, stream.n_sites, max(1, stream.n_sites // 8))],
        n_fg_sites=stream.n_sites,
    )
    tmap = fused_gb_linear_map_streamed(
        stream, cmap, kbt=0.7, spec=GBFeatSpec(outer=2.0, n_basis=3), constraints=set(),
        l2_regularization=1e3, constraint_rng=np.random.default_rng(args.seed),
        mesh=mesh, frame_slice=sl,
    )
    coefs = np.stack(tmap.force_map.tags["coef_list"])
    print(f"rank {mesh.rank}: fitted (solver resid {tmap.force_map.tags['solver_resid']:.2e}, "
          f"coefficient checksum {float(np.abs(coefs).sum()):.6f})", flush=True)
    dist.destroy_process_group()


def demo() -> None:
    """Write a small trajectory and run two gloo processes on the CPU,
    joined through a file store."""
    import numpy as np

    workdir = tempfile.mkdtemp(prefix="aggforce_sweep_")
    rng = np.random.default_rng(0)
    paths = []
    for name in ("coords", "forces"):
        paths.append(os.path.join(workdir, f"{name}.npy"))
        np.save(paths[-1], rng.normal(size=(64, 9, 3)).astype(np.float32))
    store = os.path.join(workdir, "store")
    # a share of the cores each (unless the caller set one): two CPU
    # processes both using every core spend their time waiting on each
    # other's threads
    threads = os.environ.get("OMP_NUM_THREADS") or str(max(1, (os.cpu_count() or 2) // 2))
    env = dict(os.environ, OMP_NUM_THREADS=threads)
    procs = [
        subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--store", store, "--nproc", "2",
             "--pid", str(pid), "--backend", "gloo", "--device", "cpu",
             "--coords", paths[0], "--forces", paths[1], "--chunk-size", "8"],
            stdout=subprocess.PIPE, text=True, env=env,
        )
        for pid in range(2)
    ]
    try:
        outs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for out in outs:
        print(out, end="")
    if any(p.returncode for p in procs):
        raise SystemExit(f"demo workers failed: {[p.returncode for p in procs]}")
    sums = {line.split("checksum ")[1] for out in outs for line in out.splitlines()
            if "checksum" in line}
    if len(sums) != 1:
        raise SystemExit(f"the ranks fitted different maps: {sums}")
    print("multihost sweep demo OK")


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--demo", action="store_true")
    parser.add_argument("--store", default=None, help="file store path shared by the ranks")
    parser.add_argument("--nproc", type=int, default=None)
    parser.add_argument("--pid", type=int, default=None)
    parser.add_argument("--backend", default=None, help="nccl or gloo (default: by device)")
    parser.add_argument("--device", default=None, help="default: this rank's CUDA card")
    parser.add_argument("--coords", default=None)
    parser.add_argument("--forces", default=None)
    parser.add_argument("--chunk-size", dest="chunk_size", type=int, default=4096)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    if args.demo:
        demo()
        return
    if not (args.coords and args.forces):
        parser.error("--coords/--forces required (or use --demo)")
    worker(args)


if __name__ == "__main__":
    main()
