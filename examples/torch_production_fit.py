"""Production fitting pattern with the PyTorch port: disk IO overlapped with
the program's warm-up.

The port's twin of ``examples/production_fit.py``. The end-to-end latency
of a real fitting job is set by two independent phases: loading trajectory
data from disk, and preparing the fit (building the hand-written CUDA
kernels, setting up CUDA, cuBLAS and cuSOLVER). They share no data, so
this example runs them concurrently:

  1. point the kernels' build directory at a cache
     (:func:`aggforce_torch.utils.cache.enable_compile_cache`), so later
     processes load the kernels instead of building them, and start
     :func:`aggforce_torch.utils.warmup.warm_featurized_fit` for the known
     shapes (frames, topology, featurizer spec);
  2. load coords/forces from .npy files while the warm-up runs;
  3. fit: everything is built, so the call runs at steady-state speed;
  4. serialize the fitted map for deployment.

For trajectories larger than host RAM or device memory, steps 2-3 switch to
the streamed fit (memory-mapped chunks through the device, the Gram kernel
once per chunk, :mod:`aggforce_torch.io`), shown second. When the process is
one rank of several (``torchrun``, or ``--demo``), each rank then streams
only its ``process_frame_slice`` and one all-reduce merges the Grams; on one
process that variant is skipped.

The system is a CLN025-style fixture of ``--pdb`` with its C-alpha map (the
JAX example's system), or without ``--pdb`` the JAX bench's standalone
system (bench.py:290-307). Both are made from seed 5.

Run on the card, on the CPU, on N cards of one host (NCCL), or as two CPU
processes over gloo:

    python examples/torch_production_fit.py [--frames 2000] [--pdb cln025.pdb]
    python examples/torch_production_fit.py --device cpu --frames 200
    torchrun --nproc-per-node N examples/torch_production_fit.py
    python examples/torch_production_fit.py --demo --frames 200
"""

import argparse
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 5
L2 = 1e3
CHUNK = 512


def _rms(a, b) -> float:
    import numpy as np

    return float(np.sqrt(np.mean((np.asarray(a) - np.asarray(b)) ** 2)))


def run(args) -> dict:
    import numpy as np
    import torch.distributed as dist

    sys.path.insert(0, REPO)
    from aggforce_torch.io import TrajectoryStream, fused_gb_linear_map_streamed
    from aggforce_torch.parallel import (
        initialize_distributed,
        make_mesh,
        process_frame_slice,
    )
    from aggforce_torch.qp.fusedfeat import GBFeatSpec, fused_gb_linear_map
    from aggforce_torch.trajectory import Trajectory
    from aggforce_torch.utils.cache import enable_compile_cache
    from aggforce_torch.utils.device import resolve_device
    from aggforce_torch.utils.serialize import load_tmap, save_tmap
    from aggforce_torch.utils.synth import example_system
    from aggforce_torch.utils.warmup import warm_featurized_fit

    # one rank of several under torchrun's environment or a --store file
    mesh = None
    if args.store is not None or int(os.environ.get("WORLD_SIZE", "1")) > 1:
        address = None if args.store is None else "file://" + args.store
        initialize_distributed(address, args.nproc, args.pid, backend=args.backend)
        mesh = make_mesh(device=args.device)
        device = mesh.device
    else:
        device = resolve_device(args.device)
    rank0 = mesh is None or mesh.rank == 0

    def say(msg: str) -> None:
        if rank0:
            print(msg, flush=True)

    try:
        fix, cmap, label = example_system(args.frames, SEED, args.pdb)
    except FileNotFoundError as err:
        raise SystemExit(str(err)) from None
    say(f"system: {label}")
    # stand-in for upstream MD output on disk (each rank writes its own copy)
    workdir = args.workdir or tempfile.mkdtemp(prefix="aggforce_prod_")
    if mesh is not None:
        workdir = os.path.join(workdir, f"rank{mesh.rank}")
    os.makedirs(workdir, exist_ok=True)
    coords_path = os.path.join(workdir, "coords.npy")
    forces_path = os.path.join(workdir, "forces.npy")
    np.save(coords_path, fix["coords"])
    np.save(forces_path, fix["forces"])
    kbt = float(fix["kbt"])
    constraints = set(fix["constraint_groups"])
    spec = GBFeatSpec(outer=8.0, inner=0.0, n_basis=7, width=1.0)
    fit_kw = dict(kbt=kbt, spec=spec, constraints=constraints, l2_regularization=L2)
    out = {"system": label, "workdir": workdir, "device": str(device), "coord_map": cmap,
           "constraints": constraints}

    # ---- 1. program prep in the background (shapes known before data) ----
    out["cache_dir"] = enable_compile_cache()  # honors AGGFORCE_COMPILE_CACHE
    say(f"compile cache: {out['cache_dir']}")
    t0 = time.perf_counter()
    handle = warm_featurized_fit(
        args.frames, cmap, spec, constraints, kbt=kbt, l2_regularization=L2, device=device
    )

    # ---- 2. data load overlaps the warm-up ----
    coords = np.load(coords_path)
    forces = np.load(forces_path)
    out["load_s"] = time.perf_counter() - t0
    out["exposed_s"] = handle.wait()
    out["warmup_s"] = handle.elapsed
    say(f"data load {out['load_s']:.2f}s; program prep {handle.elapsed:.2f}s in "
        f"background ({out['exposed_s']:.2f}s exposed)")

    # ---- 3. fit at steady-state speed ----
    t0 = time.perf_counter()
    tmap = fused_gb_linear_map(
        Trajectory(coords=coords, forces=forces), cmap,
        constraint_rng=np.random.default_rng(0), device=device, **fit_kw,
    )
    out["fit_s"] = time.perf_counter() - t0
    out["solver_resid"] = float(tmap.force_map.tags["solver_resid"])
    say(f"fit: {out['fit_s']:.3f}s (solver resid {out['solver_resid']:.2e})")

    # ---- 4. serialize for deployment ----
    map_path = os.path.join(workdir, "force_map.npz")
    save_tmap(map_path, tmap)
    reloaded = load_tmap(map_path, device=device)
    _, mf = tmap.map_arrays(coords[:32], forces[:32])
    _, mf_loaded = reloaded.map_arrays(coords[:32], forces[:32])
    if not np.all(np.isfinite(np.asarray(mf_loaded))):
        raise SystemExit("the reloaded map gives non-finite forces")
    out["reload_max_diff"] = float(np.abs(np.asarray(mf_loaded) - np.asarray(mf)).max())
    say(f"serialized map round-trips: {map_path} (largest mapped-force difference "
        f"{out['reload_max_diff']:.2e})")

    # ---- larger-than-memory variant: stream chunks from disk ----
    stream = TrajectoryStream.from_npy(coords_path, forces_path, chunk_size=CHUNK)
    t0 = time.perf_counter()
    tmap_s = fused_gb_linear_map_streamed(
        stream, cmap, constraint_rng=np.random.default_rng(0), device=device, **fit_kw
    )
    _, mf_s = tmap_s.map_arrays(coords[:32], forces[:32])
    out["stream_s"] = time.perf_counter() - t0
    out["stream_rms"] = _rms(mf_s, mf)
    say(f"streamed fit: {out['stream_s']:.3f}s; mapped-force RMS deviation vs "
        f"in-memory fit {out['stream_rms']:.2e}")

    # ---- multi-device variant: each rank streams its own frames ----
    if mesh is not None and mesh.size > 1:
        sl = process_frame_slice(stream.n_frames)
        t0 = time.perf_counter()
        tmap_m = fused_gb_linear_map_streamed(
            stream, cmap, constraint_rng=np.random.default_rng(0), mesh=mesh,
            frame_slice=sl, **fit_kw,
        )
        _, mf_m = tmap_m.map_arrays(coords[:32], forces[:32])
        out["mesh_s"] = time.perf_counter() - t0
        out["mesh_rms"] = _rms(mf_m, mf)
        print(f"rank {mesh.rank}: frames [{sl.start}, {sl.stop}), mesh-streamed fit "
              f"({mesh.size} ranks): {out['mesh_s']:.3f}s; RMS vs in-memory "
              f"{out['mesh_rms']:.2e}", flush=True)
        dist.destroy_process_group()
    say("production fit demo OK")
    out.update(tmap=tmap, streamed=tmap_s, coords=coords, forces=forces)
    return out


def demo(args) -> None:
    """Two gloo processes on the CPU, joined through a file store."""
    # a share of the cores each, unless the caller set one
    threads = os.environ.get("OMP_NUM_THREADS") or str(max(1, (os.cpu_count() or 2) // 2))
    env = dict(os.environ, OMP_NUM_THREADS=threads)
    extra = ["--pdb", args.pdb] if args.pdb else []
    with tempfile.TemporaryDirectory(prefix="aggforce_prod_demo_") as workdir:
        procs = [
            subprocess.Popen([
                sys.executable, os.path.abspath(__file__), "--nproc", "2", "--pid", str(pid),
                "--store", os.path.join(workdir, "store"), "--workdir", workdir,
                "--backend", "gloo", "--device", "cpu", "--frames", str(args.frames),
                *extra,
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


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--frames", type=int, default=2000)
    parser.add_argument("--pdb", default=None, help="topology PDB (default: standalone)")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--workdir", default=None, help="default: a new temporary directory")
    parser.add_argument("--demo", action="store_true", help="two gloo ranks on the CPU")
    parser.add_argument("--store", default=None, help="file store path shared by the ranks")
    parser.add_argument("--nproc", type=int, default=None)
    parser.add_argument("--pid", type=int, default=None)
    parser.add_argument("--backend", default=None, help="nccl or gloo (default: by device)")
    args = parser.parse_args(argv)
    if args.demo:
        demo(args)
        return {}
    return run(args)


if __name__ == "__main__":
    main()
