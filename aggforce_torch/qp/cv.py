r"""Single-pass cross validation of the linear force map.

Counterpart of the linear half of the JAX package's ``qp/cv.py``. The
reference CV loop refits from scratch for every (grid point, fold) pair
and re-maps the holdout data to score it (reference agg.py:204-231). Here
the procedure collapses algebraically:

  * the train-fold Gram is ``G_total - G_heldout[fold]`` — so one pass over
    the data (accumulating per-fold heldout Grams) yields every fold's
    training problem;
  * the l2 grid only shifts the Gram diagonal — so every (fold, l2) fit is
    one more problem of one batched Cholesky solve on the same Grams;
  * the holdout score itself is a Gram quadratic form: for a linear map with
    per-site reduced coefficients x_i,

        force_smoothness(mapped holdout forces)
            = sum_i x_i^T G_heldout x_i / (3 * T_fold * S)

    so no data is ever re-mapped.

Numerical contract: the batched float32 solves report their max
equilibrated constraint violation; cells exceeding ``resid_tol`` are
recomputed with the float64 oracle from the same device Grams (counted in
``qplinear.fit_routes["cv_escalated_cells"]``). At severely
under-regularized grid points the holdout quadratic form amplifies Gram
rounding by the train system's condition number, in any implementation.

The featurized single-pass CV (``fused_gb_cv``, ``fused_gb_cv_grid``) is
not ported yet (ROADMAP Queue 1 item 8).
"""

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..constraints import Constraints
from ..map import LinearMap
from ..ops.eqp import batched_eqp_solve_auglag, eqp_solve_host
from ..utils.device import DeviceLike, full_fp32, resolve_device
from .qplinear import _linear_gram, _reduced, constraint_labels, fit_routes


def _fold_segments(
    n_frames: int, n_folds: int, rng: Optional[np.random.Generator]
) -> List[np.ndarray]:
    """Shuffled frame-index folds (same construction as the generic refit loop)."""
    frames = np.arange(n_frames)
    (rng if rng is not None else np.random.default_rng()).shuffle(frames)
    return np.array_split(frames, n_folds)


def _linear_solve_scores(
    grams: torch.Tensor,  # (k, R, R) heldout Grams
    a_mat: torch.Tensor,  # (S, R)
    basis: torch.Tensor,  # (S, S)
    ridge: torch.Tensor,  # (R, R)
    l2_vec: torch.Tensor,  # (n_l2,)
):
    """Every (l2, fold) linear-map fit + holdout score in one batched solve.

    Returns the (n_l2, k) holdout quadratic forms x^T G_heldout x plus the
    per-cell equilibrated constraint violations (the convergence diagnostic
    — callers escalate individual cells to float64 when they exceed
    tolerance).
    """
    k = grams.shape[0]
    n_l2 = l2_vec.shape[0]
    g_total = torch.sum(grams, dim=0)
    p_all = (g_total - grams)[None] + l2_vec[:, None, None, None] * ridge
    flat_p = p_all.reshape(n_l2 * k, *grams.shape[1:])
    flat_a = a_mat.expand(n_l2 * k, *a_mat.shape)
    flat_b = basis.expand(n_l2 * k, *basis.shape)
    x, resids = batched_eqp_solve_auglag(
        flat_p, flat_a, flat_b, iters=40, return_resid=True
    )  # (n_l2*k, R, S)
    x = x.reshape(n_l2, k, *x.shape[1:])
    gx = torch.einsum("fij,lfjs->lfis", grams, x)
    qf = torch.sum(x * gx, dim=(2, 3))
    return qf, resids.reshape(n_l2, k)  # both (n_l2, k)


def _host_linear_scores(
    grams: np.ndarray,  # (k, R, R) heldout Grams
    a_mat: np.ndarray,  # (S, R)
    basis: np.ndarray,  # (S, S)
    ridge: np.ndarray,  # (R, R)
    l2_values: Sequence[float],
    qf: np.ndarray,  # (n_l2, k) device scores, overwritten where cells fail
    cells: np.ndarray,  # (n_l2, k) bool: True -> recompute this cell
) -> np.ndarray:
    """Float64 oracle for failing (l2, fold) cells (escalation path)."""
    g_total = grams.sum(axis=0, dtype=np.float64)
    for i, l2 in enumerate(l2_values):
        for f in range(grams.shape[0]):
            if not cells[i, f]:
                continue
            p = g_total - grams[f] + float(l2) * ridge.astype(np.float64)
            x = eqp_solve_host(p, a_mat, basis)  # (R, S)
            qf[i, f] = np.einsum(
                "rs,rq,qs->", x, grams[f].astype(np.float64), x
            )
    return qf


def _l2_blocks(
    n_l2: int, per_system_bytes: int, n_systems_per_l2: int
) -> int:
    """How many l2 values fit per batched solve under ~4 GiB of factors.

    ``per_system_bytes`` must account the direct solver's full live set
    (augmented operator + two-level batched Cholesky + Z + Schur factors),
    not just the Gram.
    """
    budget = 4 << 30
    per_l2 = max(1, per_system_bytes * n_systems_per_l2)
    return max(1, min(n_l2, budget // per_l2))


def _score_table(l2_values, qf_all: np.ndarray, denoms: np.ndarray):
    """{l2: (mean, sd, k)} from per-(l2, fold) quadratic forms and denoms."""
    out = {}
    for i, l2 in enumerate(l2_values):
        scores = qf_all[i] / denoms
        mean = float(scores.mean())
        sd = float(scores.std(ddof=1)) if scores.size > 1 else None
        out[float(l2)] = (mean, sd, int(scores.size))
    return out


@full_fp32()
def linear_map_cv(
    coords,
    forces,
    coord_map: LinearMap,
    constraints: Constraints,
    l2_values: Sequence[float],
    n_folds: int = 5,
    rng: Optional[np.random.Generator] = None,
    mesh=None,
    resid_tol: float = 1e-4,
    device: DeviceLike = None,
) -> Dict[float, Tuple[Optional[float], Optional[float], int]]:
    """K-fold CV of the optimal linear map over an l2 grid, in one pass.

    Returns {l2: (mean holdout score, sample sd, n_folds)} with scores
    identical (to float precision) to refitting per fold and evaluating
    ``force_smoothness`` on the mapped holdout forces. ``device`` (default:
    the GPU, or the device of tensor forces) is where the Grams and solves
    run, their products at full float32 precision whatever the process's
    TF32 setting.

    Convergence is checked per (l2, fold) cell: cells whose batched float32
    solve reports an equilibrated constraint violation above ``resid_tol``
    are recomputed with the float64 oracle (small systems — the Gram pass,
    the expensive part, is reused).
    """
    del coords  # constraints are supplied explicitly; coords unused
    if mesh is not None:
        raise NotImplementedError(
            "multi-device CV is not ported yet (ROADMAP Queue 1 item 13)"
        )
    dev = resolve_device(device, forces)
    labels_np, r = constraint_labels(coord_map.n_fg_sites, constraints)
    folds = _fold_segments(forces.shape[0], n_folds, rng)

    f32 = dict(dtype=torch.float32, device=dev)
    labels = torch.as_tensor(labels_np, dtype=torch.int64, device=dev)
    forces_dev = torch.as_tensor(forces, device=dev).to(torch.float32)
    # per-fold heldout Grams, one fold's frames at a time
    grams = torch.stack([
        _linear_gram(forces_dev[torch.as_tensor(idx, device=dev)], labels, r)
        for idx in folds
    ])  # (k, R, R)

    a_mat = _reduced(
        torch.as_tensor(np.asarray(coord_map.standard_matrix), **f32), labels, r
    )
    basis = torch.eye(coord_map.n_cg_sites, **f32)
    # C^T C is diagonal with the per-column member counts
    ridge = torch.diag(torch.bincount(labels, minlength=r).to(torch.float32))

    # every (l2, fold) fit + score is one batched solve per memory block;
    # per-problem live factors: the augmented operator + its two-level
    # batched Cholesky (~3 r^2 floats) plus Z and the small Schur factors
    block = _l2_blocks(len(l2_values), 4 * 4 * r * r, n_folds)
    qf_blocks = []
    resids = []
    for i in range(0, len(l2_values), block):
        l2_vec = torch.as_tensor(list(l2_values[i : i + block]), **f32)
        qf, resid = _linear_solve_scores(grams, a_mat, basis, ridge, l2_vec)
        qf_blocks.append(qf)
        resids.append(resid)
    qf_all = torch.cat(qf_blocks, dim=0).cpu().numpy().astype(np.float32)
    resid_all = torch.cat(resids, dim=0).cpu().numpy()
    bad = ~(resid_all <= resid_tol)  # NaN-aware
    if bad.any():
        # float32 solve did not converge on SOME (l2, fold) cells: redo
        # exactly those with the float64 oracle, reusing the device Grams
        fit_routes["cv_escalated_cells"] += int(bad.sum())
        qf_all = _host_linear_scores(
            grams.cpu().numpy().astype(np.float64),
            a_mat.cpu().numpy().astype(np.float64),
            basis.cpu().numpy().astype(np.float64),
            ridge.cpu().numpy().astype(np.float64),
            l2_values,
            qf_all,
            bad,
        )
    denoms = np.array(
        [3 * len(idx) * coord_map.n_cg_sites for idx in folds], dtype=np.float64
    )
    return _score_table(l2_values, qf_all, denoms)
