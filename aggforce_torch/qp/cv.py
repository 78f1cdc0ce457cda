r"""Single-pass cross validation of the linear and featurized force maps.

Counterpart of the JAX package's ``qp/cv.py``. The reference CV loop refits from scratch for every (grid point, fold) pair
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

    (and identically for featurized maps with the featurized Gram), so no
    data is ever re-mapped.

Numerical contract: the batched float32 solves report their max
equilibrated constraint violation; cells exceeding ``resid_tol`` are
recomputed with the float64 oracle from the same device Grams (counted in
``qplinear.fit_routes["cv_escalated_cells"]``). At severely
under-regularized grid points the holdout quadratic form amplifies Gram
rounding by the train system's condition number, in any implementation.

Every product runs at full float32 precision whatever TF32 setting the
process has chosen (``utils.device.full_fp32()``), as the JAX code's
``precision="highest"``.
"""

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..constraints import Constraints
from ..map import LinearMap
from ..ops.eqp import batched_eqp_solve_auglag, converged, eqp_solve_host
from ..ops.gram import site_grams
from ..parallel.mesh import FrameMesh, as_frame_mesh, mesh_device, shard_frames
from ..trajectory import Trajectory
from ..utils.device import DeviceLike, full_fp32, resolve_device
from ..utils.prof import span
from .fusedfeat import (
    _constraint_system,
    _fit_constants,
    _frames_at,
    _prepare_fused_setup,
    _site_gram,
)
from .qplinear import _linear_gram, _reduced, constraint_labels, fit_routes


def _fold_segments(
    n_frames: int,
    n_folds: int,
    rng: Optional[np.random.Generator],
    mesh: Optional[FrameMesh] = None,
) -> List[np.ndarray]:
    """Shuffled frame-index folds (same construction as the generic refit
    loop); with ``mesh``, rank 0's shuffle on every rank."""
    frames = np.arange(n_frames)
    (rng if rng is not None else np.random.default_rng()).shuffle(frames)
    if mesh is not None:
        frames = mesh.broadcast_array(frames)
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


def _featurized_solve_scores(
    grams: torch.Tensor,  # (k, S, K, K) heldout featurized Grams
    rows: torch.Tensor,  # (k, S, m, K) constraint rows
    b_all: torch.Tensor,  # (k, S, m)
    l2_vec: torch.Tensor,  # (n_l2,)
):
    """Every (l2, fold, site) featurized fit + holdout score in one batched
    solve, enqueued without a host sync.

    Returns the (n_l2, k) holdout quadratic forms summed over sites, and
    each (l2, fold) cell's equilibrated constraint violation, that of its
    worst site (the diagnostic for float64 escalation).
    """
    k, s_dim, k_exp = grams.shape[0], grams.shape[1], grams.shape[-1]
    n_l2 = l2_vec.shape[0]
    g_total = torch.sum(grams, dim=0)
    eye = torch.eye(k_exp, dtype=grams.dtype, device=grams.device)
    p_all = (g_total - grams)[None] + l2_vec[:, None, None, None, None] * eye
    flat = n_l2 * k * s_dim
    flat_p = p_all.reshape(flat, k_exp, k_exp)
    flat_a = rows.expand(n_l2, *rows.shape).reshape(flat, rows.shape[2], k_exp)
    flat_b = b_all.expand(n_l2, *b_all.shape).reshape(flat, -1, 1)
    x, resids = batched_eqp_solve_auglag(
        flat_p, flat_a, flat_b, iters=40, return_resid=True, host_checks=False
    )
    x = x[..., 0].reshape(n_l2, k, s_dim, k_exp)
    gx = torch.einsum("fsij,lfsj->lfsi", grams, x)
    qf = torch.sum(x * gx, dim=(2, 3))
    resid_cells = torch.amax(resids.reshape(n_l2, k, s_dim), dim=2)
    return qf, resid_cells  # both (n_l2, k)


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


def _host_featurized_scores(
    grams: np.ndarray,  # (k, S, K, K)
    rows: np.ndarray,  # (k, S, m, K)
    b_all: np.ndarray,  # (k, S, m)
    l2_values: Sequence[float],
    qf: np.ndarray,  # (n_l2, k) device scores, overwritten where cells fail
    cells: np.ndarray,  # (n_l2, k) bool: True -> recompute this cell
) -> np.ndarray:
    """Float64 oracle for failing featurized (l2, fold) cells."""
    k, s_dim, k_exp = grams.shape[0], grams.shape[1], grams.shape[-1]
    g_total = grams.sum(axis=0, dtype=np.float64)
    eye = np.eye(k_exp)
    for i, l2 in enumerate(l2_values):
        for f in range(k):
            if not cells[i, f]:
                continue
            total = 0.0
            for s in range(s_dim):
                p = g_total[s] - grams[f, s] + float(l2) * eye
                x = eqp_solve_host(p, rows[f, s], b_all[f, s][:, None])[:, 0]
                total += x @ grams[f, s].astype(np.float64) @ x
            qf[i, f] = total
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

    With ``mesh`` (``parallel.make_mesh``) the folds are rank 0's shuffle,
    each rank uploads and reduces only its share of every fold's frames, and
    one all-reduce sums the fold Grams; the solves, scores and escalations
    then run replicated, so every rank returns the same table.
    """
    del coords  # constraints are supplied explicitly; coords unused
    fm = as_frame_mesh(mesh) if mesh is not None else None
    dev = resolve_device(device, forces) if fm is None else mesh_device(fm, device)
    labels_np, r = constraint_labels(coord_map.n_fg_sites, constraints)
    folds = _fold_segments(forces.shape[0], n_folds, rng, fm)

    f32 = dict(dtype=torch.float32, device=dev)
    labels = torch.as_tensor(labels_np, dtype=torch.int64, device=dev)
    # per-fold heldout Grams, one fold's frames at a time
    if fm is None:
        forces_dev = torch.as_tensor(forces, device=dev).to(torch.float32)
        grams = torch.stack([
            _linear_gram(forces_dev[torch.as_tensor(idx, device=dev)], labels, r)
            for idx in folds
        ])  # (k, R, R)
    else:
        grams = fm.all_reduce(torch.stack([
            _linear_gram(shard_frames(fm, [forces], idx, pad=False)[0], labels, r)
            for idx in folds
        ]))

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
    bad = ~converged(resid_all, resid_tol, qf_all)
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


def _featurized_cv_problem(
    coords,
    forces,
    coord_map: LinearMap,
    constraints: Constraints,
    kbt: float,
    spec,
    n_folds: int,
    n_constraint_frames: int,
    rng: np.random.Generator,
    device: DeviceLike = None,
    gram_fn=site_grams,
    mesh: Optional[FrameMesh] = None,
):
    """The featurized CV's device problem: (heldout Grams (k, S, K, K),
    constraint rows (k, S, m, K), targets (k, S, m), folds, each fold's
    constraint frames (k, F)).

    The folds are drawn first, then each fold's constraint sample from its
    train frames (``n_constraint_frames`` clamped to the smallest train
    set), in the JAX package's order, so one generator gives both packages
    the same folds and samples. Each fold's Gram is one ``gram_fn`` launch
    (the Gram kernel by default) on that fold's frames, gathered and padded
    to the longest fold with masked frames, through the fit's own
    :func:`fusedfeat._site_gram`, so it lies in the layout of the
    constraint rows. With ``mesh`` the folds and samples are rank 0's, each
    rank's launch takes its share of the fold's padded frames (the only
    frames it uploads), and one all-reduce sums the fold Grams.
    """
    t = forces.shape[0]
    folds = _fold_segments(t, n_folds, rng, mesh)
    min_train = min(t - len(idx) for idx in folds)
    n_cf = min(n_constraint_frames, min_train)
    samples = np.stack([
        rng.choice(
            np.concatenate([x for j, x in enumerate(folds) if j != f]),
            size=n_cf, replace=False,
        )
        for f in range(n_folds)
    ])
    if mesh is not None:  # each fold's share is uploaded below
        setup = _fit_constants(coord_map, spec, constraints, mesh_device(mesh, device))
    else:
        setup = _prepare_fused_setup(
            Trajectory(coords=coords, forces=forces), coord_map, spec, constraints, device
        )
    dev = setup["device"]
    cmap, gmean, onehot, counts, centers = setup["consts"]
    pad_len = max(len(idx) for idx in folds)
    if mesh is not None:
        samples = mesh.broadcast_array(samples)
        pad_len = -(-pad_len // mesh.size) * mesh.size
        grams = torch.stack([
            _site_gram(
                *shard_frames(mesh, [coords, forces], idx, length=pad_len),
                cmap, gmean, onehot, counts, centers, float(kbt), spec, gram_fn,
            )
            for idx in folds
        ])
        rows, b_all = _constraint_system(
            _frames_at(coords, samples.reshape(-1), dev),
            torch.arange(samples.size, device=dev).reshape(samples.shape),
            cmap, gmean, onehot, counts, centers, spec,
        )
        return mesh.all_reduce(grams), rows, b_all, folds, samples
    coords_dev, forces_dev, _ = setup["trajectory"]
    sel = np.zeros((n_folds, pad_len), dtype=np.int64)
    mask = np.zeros((n_folds, pad_len), dtype=np.float32)
    for f, idx in enumerate(folds):
        sel[f, : len(idx)] = idx
        mask[f, : len(idx)] = 1.0
    sel_dev, mask_dev = torch.as_tensor(sel, device=dev), torch.as_tensor(mask, device=dev)
    samples_dev = torch.as_tensor(samples, device=dev)
    grams = torch.stack([
        _site_gram(
            coords_dev[sel_dev[f]], forces_dev[sel_dev[f]], mask_dev[f], cmap,
            gmean, onehot, counts, centers, float(kbt), spec, gram_fn,
        )
        for f in range(n_folds)
    ])  # (k, S, K, K)
    rows, b_all = _constraint_system(
        coords_dev, samples_dev, cmap, gmean, onehot, counts, centers, spec
    )  # (k, S, m, K), (k, S, m)
    return grams, rows, b_all, folds, samples


@span("aggforce.entry")
@full_fp32()
def fused_gb_cv(
    coords,
    forces,
    coord_map: LinearMap,
    constraints: Constraints,
    kbt: float,
    spec,
    l2_values: Sequence[float],
    n_folds: int = 5,
    n_constraint_frames: int = 20,
    rng: Optional[np.random.Generator] = None,
    mesh=None,
    resid_tol: float = 1e-4,
    device: DeviceLike = None,
) -> Dict[float, Tuple[Optional[float], Optional[float], int]]:
    """K-fold CV of the canonical featurized map over an l2 grid, one pass.

    Each fold's heldout featurized Gram is one launch of the Gram kernel on
    that fold's frames, train Grams come from subtraction, every (l2, fold,
    site) constrained fit is one problem of a batched solve per memory
    block, and holdout scores are Gram quadratic forms. ``spec`` is the
    ``GBFeatSpec`` of the featurization. Returns {l2: (mean holdout score,
    sample sd, n_folds)}, scores as ``force_smoothness`` of the mapped
    holdout forces. ``device`` (default: the GPU, or the device of tensor
    inputs) is where the Grams and solves run; the host syncs once for the
    whole grid.

    Unconverged float32 solves (equilibrated constraint violation above
    ``resid_tol``, NaN-aware) escalate exactly those (l2, fold) cells to the
    float64 oracle, reusing the device Grams; they are counted in
    ``qplinear.fit_routes["cv_escalated_cells"]``.

    With ``mesh`` (``parallel.make_mesh``) each fold's Gram is sharded over
    the ranks' frames (the kernel once per fold per rank) and summed by one
    all-reduce; folds and constraint samples are rank 0's draws, and the
    solves, scores and escalations run replicated, so every rank returns the
    same table.
    """
    fm = as_frame_mesh(mesh) if mesh is not None else None
    if rng is None:
        rng = np.random.default_rng()
    grams, rows, b_all, folds, _ = _featurized_cv_problem(
        coords, forces, coord_map, constraints, kbt, spec, n_folds,
        n_constraint_frames, rng, device, mesh=fm,
    )
    # every (l2, fold, site) fit + score: one solve per memory block. Live
    # factors per problem: the augmented operator and its Cholesky (~3 K^2
    # plus the Gram), Z (K x m) and three m x m Schur factors
    k_exp, m_rows, s_dim = grams.shape[-1], rows.shape[2], grams.shape[1]
    per_problem = 4 * (4 * k_exp * k_exp + k_exp * m_rows + 3 * m_rows * m_rows)
    block = _l2_blocks(len(l2_values), per_problem, n_folds * s_dim)
    qf_blocks = []
    resids = []
    for i in range(0, len(l2_values), block):
        l2_vec = torch.as_tensor(
            list(l2_values[i : i + block]), dtype=torch.float32, device=grams.device
        )
        qf, resid = _featurized_solve_scores(grams, rows, b_all, l2_vec)
        qf_blocks.append(qf)
        resids.append(resid)
    # the one host sync of the grid
    fetched = torch.stack([torch.cat(qf_blocks), torch.cat(resids)]).cpu().numpy()
    qf_all, resid_all = fetched[0].copy(), fetched[1]
    bad = ~converged(resid_all, resid_tol, qf_all)
    if bad.any():
        # float32 solve unconverged on SOME (l2, fold) cells: redo exactly
        # those with the float64 oracle, reusing the device Grams
        fit_routes["cv_escalated_cells"] += int(bad.sum())
        qf_all = _host_featurized_scores(
            grams.cpu().numpy().astype(np.float64),
            rows.cpu().numpy().astype(np.float64),
            b_all.cpu().numpy().astype(np.float64),
            l2_values,
            qf_all,
            bad,
        )
    denoms = np.array([3 * len(idx) * s_dim for idx in folds], dtype=np.float64)
    return _score_table(l2_values, qf_all, denoms)


def fused_gb_cv_grid(
    coords,
    forces,
    coord_map: LinearMap,
    constraints: Constraints,
    kbt: float,
    specs: Sequence,
    l2_values: Sequence[float],
    n_folds: int = 5,
    n_constraint_frames: int = 20,
    rng: Optional[np.random.Generator] = None,
    mesh=None,
    device: DeviceLike = None,
) -> Dict[Tuple[int, float], Tuple[Optional[float], Optional[float], int]]:
    """K-fold CV over a (featurizer spec x l2) grid, one Gram pass per spec.

    Different specs need their own featurized Grams, so each spec is one
    :func:`fused_gb_cv`; the (fold x l2) fits and scores of a spec reuse its
    Grams. The caller's generator state is replayed for every spec, so the
    folds and constraint samples are the same across specs, and the same as
    the generic refit loop would draw from that generator.

    Returns {(spec_index, l2): (mean score, sample sd, n_folds)}.
    """
    if rng is None:
        rng = np.random.default_rng()
    state = rng.bit_generator.state
    out: Dict[Tuple[int, float], Tuple[Optional[float], Optional[float], int]] = {}
    for i, spec in enumerate(specs):
        replay = np.random.default_rng()
        replay.bit_generator.state = state
        table = fused_gb_cv(
            coords, forces, coord_map, constraints, kbt=kbt, spec=spec,
            l2_values=l2_values, n_folds=n_folds,
            n_constraint_frames=n_constraint_frames, rng=replay, mesh=mesh,
            device=device,
        )
        for l2, stats in table.items():
            out[(i, float(l2))] = stats
    return out
