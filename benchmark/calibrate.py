"""Readings that the limits of ``correct`` are set from.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,3 \
        --control-seeds 4,5,6 [--fits 2]

For each of ``--seeds`` it makes the cell's pool, runs ``--fits`` fits
through the cell's entry exactly as a run's first fits (same offsets and
generators) and prints the check's numbers of the program's outputs; for
each of ``--control-seeds`` it prints the numbers of the control, the
reference solved and applied in TF32 in the program's place, on the same
fits. One JSON line per seed and a last line with the largest program
reading and the smallest control reading of each number. The benchmark's
runs never call this.

A cell on several chips takes only ``--control-seeds`` here (the control
needs no ranks, one card); its program readings are the checks that its
runs print (``run.py``, one rank per card).
"""

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def _ints(text: str):
    return [int(x) for x in text.split(",") if x]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=_ints, default=[])
    parser.add_argument("--control-seeds", type=_ints, default=[])
    parser.add_argument("--fits", type=int, default=1)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from benchmark import harness

    cell = harness.load_cell(args.workload, False)
    if cell.chips > 1 and args.seeds:
        parser.error(f"{args.workload} runs on {cell.chips} ranks: its program readings come from run.py")
    device = torch.device(args.device)
    summary = {"program": {}, "control": {}}
    for seed in sorted(set(args.seeds) | set(args.control_seeds)):
        readings = harness.calibration_readings(
            cell, seed, args.fits, device,
            program=seed in args.seeds, control=seed in args.control_seeds,
        )
        print(json.dumps({"seed": seed, **readings}), flush=True)
        for side, pick in (("program", max), ("control", min)):
            for name, value in readings.get(side, {}).items():
                prev = summary[side].get(name)
                summary[side][name] = value if prev is None else pick(prev, value)
    print(json.dumps({"workload": args.workload, "largest_program": summary["program"],
                      "smallest_control": summary["control"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
