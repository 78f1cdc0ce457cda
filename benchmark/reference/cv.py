r"""Plain reference of the cross-validated hyperparameter study
(``entries/grid_cv.py``): every fold refitted from its train frames and
scored on its held-out frames, as upstream's refit loop does
(``agg.project_forces_grid_cv``, upstream agg.py:204-231).

A study on a window of T frames:

1. constraints: atom pairs whose distance sd over the first
   ``detect_frames`` frames is below ``detect_threshold``
   (``reference/detect.py``), and the groups they join;
2. the control: the static linear map's k-fold CV at
   ``control_l2_regularization`` (``reference/linear.py``);
3. the grid: for each featurizer point (``grid`` over the base
   ``featurizer``), each l2 of ``l2_regularization``, each fold and each cg
   site, the design rows X_s of the fold's train frames, the constrained
   least squares min x^T (X_s^T X_s + l2 I) x subject to the constraint rows
   of the fold's constraint frames (``reference/featurized.py``,
   ``numerics.eq_lstsq``), and the held-out frames mapped, X_s[held] x.

A fold's score is ``force_smoothness`` of its mapped held-out forces: their
mean square over frames, sites and components. A grid point's entry is the
mean over the folds and their sample sd.

The train Gram of each fold is summed from that fold's own train rows; it is
never the whole window's Gram less the held-out fold's, as the program's
single-pass CV takes it.

The random draws are a frozen copy of the program's rule, so that a later
change to the program cannot move them: the study's generator spawns two
(the control's, the grid's); each CV shuffles ``arange(T)`` with its
generator and splits it into ``n_folds`` nearly equal folds
(``np.array_split``); the grid's generator then draws, for each fold in
turn, ``min(n_constraint_frames, smallest train set)`` constraint frames
from that fold's train frames (the other folds in order, concatenated)
without replacement, and every featurizer point replays the grid
generator's state from before the shuffle, so all points share the folds
and the samples.
"""

import dataclasses
from itertools import product
from typing import Dict, List

import numpy as np
import torch

from . import detect, featurized, linear
from .numerics import dtype_of, eq_lstsq, full_precision, mm


def grid_points(cfg: Dict) -> List[Dict]:
    """The featurizer of each grid point: the base ``featurizer`` with the
    ``grid``'s keys set, the grid's first key varying slowest."""
    grid = cfg["grid"]
    keys = list(grid)
    return [dict(cfg["featurizer"], **dict(zip(keys, values))) for values in product(*grid.values())]


def draws(n_frames: int, n_folds: int, n_constraint_frames: int, rng: np.random.Generator):
    """(the control's folds, the grid's folds, the grid's (n_folds, F)
    constraint frames) from the study's generator (the module's rule)."""
    control_rng, grid_rng = rng.spawn(2)

    def folds(gen):
        frames = np.arange(n_frames)
        gen.shuffle(frames)
        return np.array_split(frames, n_folds)

    control_folds = folds(control_rng)
    grid_folds = folds(grid_rng)
    trains = [np.concatenate([x for j, x in enumerate(grid_folds) if j != f]) for f in range(n_folds)]
    n_cf = min(n_constraint_frames, min(len(t) for t in trains))
    samples = np.stack([grid_rng.choice(t, size=n_cf, replace=False) for t in trains])
    return control_folds, grid_folds, samples


def _train(folds, f: int) -> np.ndarray:
    return np.concatenate([x for j, x in enumerate(folds) if j != f])


def control_scores(system, cfg: Dict, forces, pairs, folds, precision: str) -> np.ndarray:
    """(k,) holdout scores of the static linear map refitted per fold."""
    labels = linear.groups_from_pairs(system.n_atoms, pairs)
    l2 = float(cfg["control_l2_regularization"])
    dev = forces.device
    out = []
    for f, held in enumerate(folds):
        train = torch.as_tensor(_train(folds, f), device=dev)
        w = linear.solve_map(forces[train], system.cmap_matrix(), labels, l2, precision)
        mapped = linear.apply_map(w, forces[torch.as_tensor(held, device=dev)], precision)
        out.append(float(torch.mean(mapped.double() ** 2)))
    return np.array(out)


def _with_groups(system, pairs):
    """``system`` with the constraint groups of ``pairs`` in place of its own."""
    labels = linear.groups_from_pairs(system.n_atoms, pairs)
    groups = [np.flatnonzero(labels == g).tolist() for g in range(int(labels.max()) + 1)]
    return dataclasses.replace(system, pairs=sorted(pairs), groups=groups)


def _solve(p, a, b, precision: str) -> torch.Tensor:
    """``eq_lstsq``; below float64 a cost matrix that the precision cannot
    factor (its Cholesky fails) gives NaN coefficients, so that point's
    score reads as not computed."""
    try:
        return eq_lstsq(p, a, b, precision)
    except torch.linalg.LinAlgError:
        if precision == "float64":
            raise
        return torch.full((p.shape[0], b.shape[1]), float("nan"), dtype=p.dtype, device=p.device)


def grid_scores(system, cfg: Dict, coords, forces, pairs, folds, samples, precision: str) -> np.ndarray:
    """(points, l2 values, k) holdout scores of the featurized maps refitted
    per fold, each site's train Gram summed from its train rows."""
    dev, dt = coords.device, dtype_of(precision)
    grouped = _with_groups(system, pairs)
    l2s = [float(v) for v in cfg["l2_regularization"]]
    points = grid_points(cfg)
    n_sites = len(system.sites)
    held_idx = [torch.as_tensor(h, device=dev) for h in folds]
    train_idx = [torch.as_tensor(_train(folds, f), device=dev) for f in range(len(folds))]
    sq = np.zeros((len(points), len(l2s), len(folds)))
    for p, point in enumerate(points):
        fs = featurized.FeatSystem(grouped, dict(cfg, featurizer=point, l2_regularization=0.0), dev, dt)
        eye = torch.eye(fs.k_exp, dtype=dt, device=dev)
        for s in range(n_sites):
            rows = torch.cat([
                featurized.design_rows(
                    fs, coords[lo : lo + featurized.FRAME_BLOCK].to(dt),
                    forces[lo : lo + featurized.FRAME_BLOCK].to(dt), s, precision,
                )
                for lo in range(0, coords.shape[0], featurized.FRAME_BLOCK)
            ])  # (T, 3, K)
            for f in range(len(folds)):
                gram = torch.zeros((fs.k_exp, fs.k_exp), dtype=dt, device=dev)
                train = train_idx[f]
                for lo in range(0, train.numel(), featurized.FRAME_BLOCK):
                    block = rows[train[lo : lo + featurized.FRAME_BLOCK]].reshape(-1, fs.k_exp)
                    gram += mm(block.T, block, precision)
                cc = coords[torch.as_tensor(samples[f], device=dev)].to(dt)
                a, b = featurized.constraint_system(fs, cc, s, precision)
                held = rows[held_idx[f]].reshape(-1, fs.k_exp)
                for li, l2 in enumerate(l2s):
                    x = _solve(gram + l2 * eye, a, b, precision)
                    mapped = mm(held, x, precision).double()
                    sq[p, li, f] += float(torch.sum(mapped * mapped))
    n_held = np.array([3 * len(h) * n_sites for h in folds], dtype=np.float64)
    return sq / n_held


def study(system, cfg: Dict, coords, forces, rng: np.random.Generator, precision: str = "float64") -> Dict:
    """The study of one window of (T, N, 3) coordinates and forces, drawn
    from the study's generator ``rng``: ``scores`` and ``sds`` (points, l2
    values), ``fold_scores`` (points, l2 values, k), ``control`` and
    ``control_folds`` (k,), ``pairs`` the detected constraints."""
    t = coords.shape[0]
    control_folds, folds, samples = draws(
        t, int(cfg["n_folds"]), int(cfg["n_constraint_frames"]), rng
    )
    with full_precision():
        pairs = detect.detect(
            coords[: int(cfg["detect_frames"])], precision, float(cfg["detect_threshold"])
        )
        control = control_scores(system, cfg, forces, pairs, control_folds, precision)
        fold_scores = grid_scores(system, cfg, coords, forces, pairs, folds, samples, precision)
    return {
        "scores": fold_scores.mean(axis=-1),
        "sds": fold_scores.std(axis=-1, ddof=1),
        "fold_scores": fold_scores,
        "control": float(control.mean()),
        "control_folds": control,
        "pairs": pairs,
    }
