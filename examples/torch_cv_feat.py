"""Cross-validated featurized force maps with hyperparameter grids, with the
PyTorch port.

The port's twin of ``examples/cv_feat.py``: a hyperparameter study for a
configuration-dependent force map,

  1. make the data, build the configurational map, detect constraints;
  2. score a configuration-INdependent control map by cross validation so
     the featurized results have a meaningful baseline;
  3. build a grid of composite id+gb featurizers (``gen_feater_grid``) over
     basis size / cutoff / width, crossed with l2 regularization values;
  4. run k-fold CV over the full grid: every (featurizer, l2, fold) fit goes
     through the single-pass CV (one Gram pass per fold of each featurizer,
     the hand-written Gram kernel on a card; all fold/l2 solves batched);
  5. tabulate (``make_rows``, rows sorted by score), drop constant columns
     (``prune``), print a fixed-width table and save CSV, and refit the best
     configuration on the full data.

The table is built without pandas: rows of dicts, written with ``csv``. The
refit draws its constraint frames from ``default_rng(0)``, so a rerun gives
the same map (the JAX example draws them unseeded).

The system is a CLN025-style fixture of ``--pdb`` with its C-alpha map (the
JAX example's system), or without ``--pdb`` the JAX bench's standalone
system (bench.py:290-307). Both are made from seed 31.

Run on the card, or on the CPU:

    python examples/torch_cv_feat.py [--frames 2000] [--folds 5] [--quick] [--csv out.csv]
    python examples/torch_cv_feat.py --device cpu --frames 100 --folds 2 --quick
"""

import argparse
import csv
import os
import sys
from itertools import product
from typing import Any, Dict, List

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from aggforce_torch.agg import (  # noqa: E402
    NRUNS_KNAME,
    RESIDUAL_KNAME,
    SCORES_KNAME,
    SDS_KNAME,
    TMAP_KNAME,
)
from aggforce_torch.qp import Multifeaturize, gb_feat, id_feat  # noqa: E402
from aggforce_torch.utils import Curry  # noqa: E402

SEED = 31
DEFAULT_FEAT_ARGS: Dict[str, Any] = {
    "inner": 0.0,
    "outer": 8.0,
    "width": 1.0,
    "n_basis": 7,
}


def gen_feater(**kwargs: Any) -> Multifeaturize:
    """Composite featurizer: one-hot identity features + curried gb_feat."""
    prod_kwargs = dict(DEFAULT_FEAT_ARGS)
    prod_kwargs.update(kwargs)
    return Multifeaturize([id_feat, Curry(gb_feat, **prod_kwargs)])


def gen_feater_grid(**kwargs: Any) -> List[Multifeaturize]:
    """All-combinations grid of composite featurizers.

    ``gen_feater_grid(n_basis=[5, 7], outer=[6.0, 8.0])`` yields the four
    featurizers with those hyperparameters baked in via Curry.
    """
    arg_keys, arg_values = zip(*kwargs.items())
    return [
        gen_feater(**dict(zip(arg_keys, values)))
        for values in product(*arg_values)
    ]


def make_rows(cv_results, key: str = SCORES_KNAME) -> List[Dict[str, Any]]:
    """Tabulate CV output: one row per grid point, hyperparameters unpacked,
    sorted by ``key`` (a point without a score last).

    Featurizer labels are expanded into their curried gb_feat keyword
    arguments, so the table reads as a flat hyperparameter study. Each row's
    ``index`` is its place in the grid's order.
    """
    rows = []
    for index, (label, value) in enumerate(cv_results[key].items()):
        row: Dict[str, Any] = {"index": index}
        if hasattr(label, "featurizer"):
            row.update(label.featurizer.featurizers[1].kwargs)
        if hasattr(label, "l2_regularization"):
            row["l2"] = label.l2_regularization
        row[key] = value
        row["sd"] = cv_results[SDS_KNAME][label]
        row["n_runs"] = cv_results[NRUNS_KNAME][label]
        rows.append(row)
    return sorted(rows, key=lambda r: (r[key] is None, r[key] or 0.0))


def prune(rows: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Drop columns carrying a single value over all rows (readability
    helper); ``index`` stays."""
    columns = list(dict.fromkeys(k for row in rows for k in row))
    keep = [
        c for c in columns
        if c == "index" or len({repr(row.get(c)) for row in rows}) > 1
    ]
    return [{c: row.get(c) for c in keep} for row in rows]


def _cell(value: Any) -> str:
    return f"{value:.6g}" if isinstance(value, float) else str(value)


def format_table(rows: List[Dict[str, Any]]) -> str:
    """Right-aligned fixed-width table of ``rows`` (without ``index``)."""
    columns = [c for c in rows[0] if c != "index"] if rows else []
    cells = [[_cell(row.get(c)) for c in columns] for row in rows]
    widths = [max([len(c)] + [len(r[i]) for r in cells]) for i, c in enumerate(columns)]
    lines = [" ".join(c.rjust(w) for c, w in zip(columns, widths))]
    lines += [" ".join(v.rjust(w) for v, w in zip(r, widths)) for r in cells]
    return "\n".join(lines)


def write_csv(path: str, rows: List[Dict[str, Any]]) -> None:
    """The table as CSV, the grid index first (an unnamed column)."""
    columns = list(rows[0]) if rows else []
    with open(path, "w", newline="") as fh:
        writer = csv.writer(fh)
        writer.writerow(["" if c == "index" else c for c in columns])
        for row in rows:
            writer.writerow([row.get(c) for c in columns])


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--frames", type=int, default=2000)
    parser.add_argument("--folds", type=int, default=5)
    parser.add_argument(
        "--quick", action="store_true", help="tiny grid for smoke runs"
    )
    parser.add_argument("--csv", default=None, help="write pruned table here")
    parser.add_argument("--pdb", default=None, help="topology PDB (default: standalone)")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    import numpy as np

    from aggforce_torch.agg import project_forces, project_forces_grid_cv
    from aggforce_torch.constraints import guess_pairwise_constraints
    from aggforce_torch.qp import qp_feat_linear_map
    from aggforce_torch.utils.device import resolve_device
    from aggforce_torch.utils.synth import example_system

    device = resolve_device(args.device)
    try:
        fix, cmap, label = example_system(args.frames, SEED, args.pdb)
    except FileNotFoundError as err:
        raise SystemExit(str(err)) from None
    print(f"system: {label}", flush=True)
    coords, forces, kbt = fix["coords"], fix["forces"], float(fix["kbt"])
    constraints = guess_pairwise_constraints(coords[:10], threshold=1e-3, device=device)
    print(f"detected {len(constraints)} constraint pairs", flush=True)

    # --- control: configuration-independent optimal map, same CV protocol ---
    control = project_forces_grid_cv(
        cv_arg_dict={"l2_regularization": [1e3]},
        coords=coords,
        forces=forces,
        n_folds=args.folds,
        coord_map=cmap,
        constrained_inds=constraints,
        rng=np.random.default_rng(0),
        device=device,
    )
    control_score = next(iter(control[SCORES_KNAME].values()))
    print(f"static-map control holdout residual: {control_score:.4f}\n")

    # --- featurized hyperparameter study ---
    if args.quick:
        feats = gen_feater_grid(n_basis=[5, 7], outer=[8.0])
        l2s = [1e1, 1e3]
    else:
        feats = gen_feater_grid(
            n_basis=[5, 7, 9], outer=[6.0, 8.0], width=[1.0, 2.0]
        )
        l2s = [1e1, 1e2, 1e3, 1e4]
    grid = {"featurizer": feats, "l2_regularization": l2s}
    print(
        f"grid: {len(feats)} featurizers x {len(l2s)} l2 values "
        f"x {args.folds} folds = {len(feats) * len(l2s) * args.folds} fits"
    )
    results = project_forces_grid_cv(
        cv_arg_dict=grid,
        coords=coords,
        forces=forces,
        n_folds=args.folds,
        coord_map=cmap,
        constrained_inds=constraints,
        method=qp_feat_linear_map,
        kbt=kbt,
        rng=np.random.default_rng(0),
        device=device,
    )

    rows = make_rows(results)
    pruned = prune(rows)
    print(format_table(pruned))
    if args.csv:
        write_csv(args.csv, pruned)
        print(f"saved pruned table to {args.csv}")

    best_label = min(results[SCORES_KNAME], key=results[SCORES_KNAME].get)
    best_score = results[SCORES_KNAME][best_label]
    improvement = control_score / best_score
    print(
        f"\nbest point: {best_label.featurizer.featurizers[1].kwargs} "
        f"l2={best_label.l2_regularization:g} "
        f"(residual {best_score:.4f}, "
        f"{improvement:.2f}x below the static control)"
    )

    # --- refit the winner on the full trajectory ---
    final = project_forces(
        coords=coords,
        forces=forces,
        coord_map=cmap,
        constrained_inds=constraints,
        method=qp_feat_linear_map,
        featurizer=best_label.featurizer,
        l2_regularization=best_label.l2_regularization,
        kbt=kbt,
        constraint_rng=np.random.default_rng(0),
        device=device,
    )
    refit = float(final[RESIDUAL_KNAME])
    print(
        f"full-data refit residual: {refit:.4f} "
        f"(tmap: {type(final[TMAP_KNAME]).__name__})",
        flush=True,
    )
    return {
        "system": label,
        "coords": coords,
        "forces": forces,
        "coord_map": cmap,
        "kbt": kbt,
        "constraints": constraints,
        "control_score": control_score,
        "featurizers": feats,
        "l2s": l2s,
        "results": results,
        "rows": rows,
        "best": best_label,
        "best_score": best_score,
        "refit": final,
        "refit_residual": refit,
    }


if __name__ == "__main__":
    main()
