"""Run one cell of the benchmark once and print its result.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The last line of standard output is one JSON
object (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
traced also ``breakdown``, and last ``checks``: each number the check
compared beside its limit); the same numbers are the last lines of standard
error. Without a CUDA card, or if JAX, Flax or the JAX package is loaded
once the window has closed, it prints no result and exits with a code
other than 0.

A cell with ``chips`` n > 1 runs one process per card: this process is rank
0 on ``cuda:0`` and starts ranks 1..n-1 on ``cuda:1``.. before its own
imports (``benchmark/ranks.py``); only rank 0 prints to standard output.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
# build and kernel caches at fixed paths inside the checkout
CACHES = {
    "TORCH_EXTENSIONS_DIR": "torch_extensions",
    "TRITON_CACHE_DIR": "triton",
    "CUDA_CACHE_PATH": "cuda",
}
# the device type the ranks run on; the benchmark's CPU tests set "cpu"
DEVICE_TYPE = "cuda"


THREAD_VARS = ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS")


def _card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=False,
        )
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.TimeoutExpired) as err:
        return f"nvidia-smi unavailable: {err!r}"


def cell_chips(workload: str) -> int:
    """The cell's ``chips`` in ``BENCHMARK.json`` (1 for an unknown name,
    which the harness then refuses), read before torch is imported."""
    with open(ROOT / "BENCHMARK.json") as fh:
        cells = {w["name"]: w for w in json.load(fh)["workloads"]}
    return int(cells.get(workload, {}).get("chips", 1))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    # a child rank's arguments, given by rank 0 only
    parser.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    parser.add_argument("--world", type=int, default=0, help=argparse.SUPPRESS)
    parser.add_argument("--store", default=None, help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if cell_chips(args.workload) > 1 or args.rank > 0:
        return _main_ranks(args, list(sys.argv[1:] if argv is None else argv))

    # one process on few threads: host math single-threaded, the process
    # (and the threads CUDA starts) held to two CPUs
    for var in THREAD_VARS:
        os.environ[var] = "1"
    cpus = sorted(os.sched_getaffinity(0))
    os.sched_setaffinity(0, set(cpus[-2:]))
    for var, sub in CACHES.items():
        os.environ[var] = str(ROOT / ".bench_cache" / sub)
    sys.path.insert(0, str(ROOT))
    import torch

    torch.set_num_threads(1)
    from benchmark import harness

    def log(msg: str) -> None:
        print(f"[{harness.process_age():9.3f} s] {msg}", file=sys.stderr, flush=True)

    cell = harness.load_cell(args.workload, bool(args.trace))
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(
            f"{args.workload} needs {cell.chips} CUDA device(s); "
            f"available: {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
            file=sys.stderr,
        )
        return 2
    log(f"card: {_card_line()}; peaks: TF32 495 TFLOP/s, HBM 3.35 TB/s (H100 SXM, 700 W)")
    result = harness.run_cell(
        cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0), log
    )
    loaded = harness.forbidden_modules()
    if loaded:
        print(f"forbidden modules loaded: {loaded}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


def _main_ranks(args, argv) -> int:
    """One rank of a cell on several chips. Rank 0 starts the others first,
    so that their set-up runs beside its own; any failure ends every rank
    with a code other than 0 and no result."""
    sys.path.insert(0, str(ROOT))
    from benchmark import ranks

    rank = args.rank
    world = args.world or cell_chips(args.workload)
    children = None
    store_dir = args.store
    if rank == 0:
        store_dir = tempfile.mkdtemp(prefix="bench_ranks_")
        children = ranks.spawn(sys.argv[0], argv, world, store_dir)
    else:
        ranks.follow_parent()

    def early(msg: str) -> None:
        print(msg, file=sys.stderr, flush=True)

    try:
        for var in THREAD_VARS:
            os.environ[var] = "1"
        os.sched_setaffinity(0, set(ranks.cpus_of(rank, world, early)))
        for var, sub in CACHES.items():
            os.environ[var] = str(ROOT / ".bench_cache" / sub)
        import torch

        torch.set_num_threads(1)
        from benchmark import harness

        def log(msg: str) -> None:
            print(f"[{harness.process_age():9.3f} s] {msg}", file=sys.stderr, flush=True)

        cell = harness.load_cell(args.workload, bool(args.trace))
        if DEVICE_TYPE == "cuda" and (
            not torch.cuda.is_available() or torch.cuda.device_count() < world
        ):
            print(
                f"{args.workload} needs {world} CUDA device(s); "
                f"available: {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                file=sys.stderr,
            )
            if children is not None:
                children.kill()
            ranks.exit_now(2, store_dir if rank == 0 else None)
        if children is not None:
            children.watch(log)
        if rank == 0:
            log(f"cards: {_card_line()}; peaks: TF32 495 TFLOP/s, HBM 3.35 TB/s (H100 SXM, 700 W)")
        link = ranks.Link(rank, world, store_dir)
        device = torch.device(DEVICE_TYPE, rank) if DEVICE_TYPE == "cuda" else torch.device("cpu")
        result = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace), device, log, link)
        if rank > 0:
            # once the window has closed, each rank looks for JAX in its own
            # process: a code other than 0 makes rank 0 refuse the run
            loaded = harness.forbidden_modules()
            if loaded:
                print(f"forbidden modules loaded: {loaded}", file=sys.stderr, flush=True)
            ranks.exit_now(3 if loaded else 0)
        if not children.finish(log):
            log("a rank did not exit cleanly after posting its results")
            ranks.exit_now(1, store_dir)
        loaded = harness.forbidden_modules()
        if loaded:
            print(f"forbidden modules loaded: {loaded}", file=sys.stderr)
            ranks.exit_now(3, store_dir)
        for name, c in result["checks"].items():
            print(f"check {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
        print(json.dumps(result), flush=True)
        ranks.exit_now(0, store_dir)
    except Exception:  # any failure of a rank ends the whole run
        import traceback

        traceback.print_exc()
        if children is not None:
            children.kill()
        ranks.exit_now(1, store_dir if rank == 0 else None)
    return 1  # not reached: every path above ends the process


if __name__ == "__main__":
    sys.exit(main())
