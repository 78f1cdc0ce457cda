"""Optimal static linear force maps via constrained least squares.

Counterpart of the JAX package's ``qp/qplinear.py``. Behavior parity target:
reference qp/qplinear.py:30-164. The optimization problem is identical — for
each cg site i,

    minimize  x^T P x,   P = (F C)^T (F C) [+ l2 * C^T C]
    s.t.      (M C) x = e_i

with F the (3T, n_fg) stacked forces, M the coordinate map matrix, and C the
constraint duplication matrix tying constrained atoms to shared coefficients.

All n_cg per-site QPs share (P, A): the device fit solves them at once with
one multi-right-hand-side solve (:func:`aggforce_torch.ops.eqp.eqp_solve_auglag`)
after a Gram accumulated over frame blocks in float32, and checks its own
convergence: an unconverged or non-finite solve is redone by the float64
host fit. ``fit_routes`` counts the fits that take each route.
"""

from collections import Counter
from typing import Optional, Tuple, TypedDict, Union

import numpy as np
import torch

from ..constraints import Constraints, constraint_lookup_dict, reduce_constraint_sets
from ..map import LinearMap, SeperableTMap, TLinearMap
from ..ops.core import qp_form
from ..ops.eqp import converged, eqp_solve_auglag, eqp_solve_host
from ..parallel.mesh import as_frame_mesh, make_mesh, mesh_device, shard_frames
from ..trajectory import ForcesTrajectory
from ..utils.device import DeviceLike, full_fp32, resolve_device
from ..utils.prof import span

# frames per Gram block of the device fit: the live (3 * block, N) force
# rows and their (3 * block, R) reduced design stay a few hundred MB at
# sweep width (3,000 atoms)
FRAME_BLOCK = 4096

# refinement sweeps of the float32 device solves of the featurized protocol
# path (``qp_feat_linear_map`` with a generic featurizer)
DEVICE_REFINE_ITERS = 40

# fits per route since the last clear(): "device", "host", and
# "escalated" (device fits redone by the float64 host fit);
# ``linear_map_cv`` adds "cv_escalated_cells", the (l2, fold) cells it
# recomputed in float64
fit_routes: Counter = Counter()


class SolverOptions(TypedDict, total=False):
    """Knobs for the constrained solvers.

    ``backend``: "device" (Gram and solve on the torch device, in float64
    for float64 forces and float32 otherwise), "host" (float64 LAPACK KKT),
    or "auto" (host for float64 forces when the fit runs on the CPU, device
    otherwise); any other backend raises ValueError. ``delta``: diagonal
    regularization after equilibration (host). ``refine_iters``: refinement
    iterations of the host solver. ``resid_tol``: max equilibrated
    constraint violation tolerated from the float32 device solve before
    escalating to the float64 host fit. Unknown keys (e.g. the reference's
    OSQP options such as "solver", "eps_abs", "max_iter", "polish") are
    accepted and ignored so reference call sites keep working.
    """

    backend: str
    delta: float
    refine_iters: int
    resid_tol: float


DEFAULT_SOLVER_OPTIONS: SolverOptions = {
    "backend": "auto",
}

_KNOWN_OPTION_KEYS = frozenset(("backend", "delta", "refine_iters", "resid_tol"))

_BACKENDS = ("auto", "device", "host")


def _solver_opts(solver_args: Optional[dict]) -> SolverOptions:
    out = dict(DEFAULT_SOLVER_OPTIONS)
    for k, v in (solver_args or {}).items():
        if k in _KNOWN_OPTION_KEYS:
            out[k] = v
    if out["backend"] not in _BACKENDS:
        raise ValueError(
            f"unknown solver backend {out['backend']!r}: use one of "
            + ", ".join(repr(b) for b in _BACKENDS)
        )
    return out  # type: ignore[return-value]


def _host_array(x) -> np.ndarray:
    """A numpy view or copy of a numpy array or a tensor on any device."""
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _numpy_dtype(x) -> np.dtype:
    """The numpy dtype of an array or tensor, without copying its data."""
    if isinstance(x, torch.Tensor):
        return torch.empty((), dtype=x.dtype).numpy().dtype
    return np.asarray(x).dtype


def _reduced(rows: torch.Tensor, labels: torch.Tensor, r: int) -> torch.Tensor:
    """``rows @ C`` for the duplication matrix C = one_hot(labels): (k, N) ->
    (k, R), each reduced column the sum of its group's columns."""
    return rows.new_zeros((rows.shape[0], r)).index_add_(1, labels, rows)


@span("aggforce.gram")
def _linear_gram(
    forces: torch.Tensor,
    labels: torch.Tensor,
    r: int,
    dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """(R, R) Gram (F C)^T (F C) of (T, N, 3) forces, summed over frame blocks.

    The duplication matrix C is never built: the reduced design rows come
    from an ``index_add_`` over ``labels`` (each group's members summed into
    its column, the same terms as the one-hot product). The frames are cut
    into equal blocks of at most ``FRAME_BLOCK``, so only one (3 * block, R)
    design block is ever live, and the block Grams are summed in ``dtype``
    (default: the forces' dtype; each block is cast to it first).
    """
    t, n, _ = forces.shape
    dtype = forces.dtype if dtype is None else dtype
    n_chunks = max(1, -(-t // FRAME_BLOCK))
    chunk = max(1, -(-t // n_chunks))  # a mesh rank may hold no frames
    gram = torch.zeros((r, r), dtype=dtype, device=forces.device)
    for start in range(0, t, chunk):
        block = forces[start : start + chunk].to(dtype)
        design = _reduced(block.transpose(1, 2).reshape(-1, n), labels, r)
        gram.addmm_(design.T, design)
    return gram


@full_fp32()
def _device_linear_fit(
    forces: torch.Tensor,
    labels: torch.Tensor,  # (N,) int64: site -> reduced-coefficient column
    cmap_mat: torch.Tensor,
    l2_regularization: float,
    r: int,
    reduce=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Device fit: blockwise Gram + multi-RHS solve + re-expansion.

    forces: (T, N, 3); cmap_mat: (n_cg, N). The Gram is
    :func:`_linear_gram`, summed in the forces' dtype (float32 on the main
    path), and every product runs at full precision whatever the process's
    TF32 setting. ``reduce`` sums the Gram of this rank's frames over the
    ranks of a mesh (``FrameMesh.all_reduce``). Returns the (n_cg, N)
    force-map matrix and the solver's constraint-violation diagnostic.
    """
    gram = _linear_gram(forces, labels, r)
    if reduce is not None:
        gram = reduce(gram)
    return _solve_linear_gram(gram, labels, cmap_mat, l2_regularization, r)


@span("aggforce.solve")
@full_fp32()
def _solve_linear_gram(
    gram: torch.Tensor,
    labels: torch.Tensor,
    cmap_mat: torch.Tensor,
    l2_regularization: float,
    r: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The device fit's solve from its (R, R) force Gram: the l2 term, the
    constraint matrix, the multi-RHS solve and the re-expansion (also the
    finish of the streamed fit). Returns (map matrix, solver diagnostic)."""
    # C^T C is diagonal with the per-column member counts
    counts = torch.bincount(labels, minlength=r).to(gram.dtype)
    gram = gram + l2_regularization * torch.diag(counts)
    a_mat = _reduced(cmap_mat, labels, r)
    basis = torch.eye(a_mat.shape[0], dtype=gram.dtype, device=gram.device)
    x, resid = eqp_solve_auglag(gram, a_mat, basis, return_resid=True)
    # re-expansion C @ x is a row gather; row-major, as every map matrix
    return x[labels].T.contiguous(), resid


def _host_linear_fit(
    forces: np.ndarray,
    con_mat: np.ndarray,
    cmap_mat: np.ndarray,
    l2_regularization: float,
    delta: float = 1e-12,
    refine_iters: int = 4,
) -> np.ndarray:
    """Float64 host twin of :func:`_device_linear_fit` (LAPACK KKT solve)."""
    return _host_linear_fit_from_gram(
        _host_linear_gram(forces, con_mat), con_mat, cmap_mat, l2_regularization,
        delta, refine_iters,
    )


def _host_linear_gram(forces: np.ndarray, con_mat: np.ndarray) -> np.ndarray:
    """Float64 (R, R) Gram (F C)^T (F C) of (T, N, 3) forces on the host."""
    design = qp_form(np.asarray(forces, dtype=np.float64)) @ con_mat
    return design.T @ design


def _host_linear_fit_from_gram(
    gram: np.ndarray,
    con_mat: np.ndarray,
    cmap_mat: np.ndarray,
    l2_regularization: float,
    delta: float = 1e-12,
    refine_iters: int = 4,
) -> np.ndarray:
    """The host fit's solve from its float64 Gram (also the streamed fit's
    escalation); returns the (n_cg, N) map matrix."""
    if l2_regularization > 0.0:
        gram = gram + l2_regularization * (con_mat.T @ con_mat)
    a_mat = np.asarray(cmap_mat, dtype=np.float64) @ con_mat
    basis = np.eye(a_mat.shape[0])
    x = eqp_solve_host(gram, a_mat, basis, delta=delta, refine_iters=refine_iters)
    return (con_mat @ x).T


@span("aggforce.entry")
def qp_linear_map(
    traj: ForcesTrajectory,
    coord_map: LinearMap,
    constraints: Optional[Constraints] = None,
    l2_regularization: float = 0.0,
    solver_args: Optional[Union[SolverOptions, dict]] = None,
    mesh=None,
    device: DeviceLike = None,
) -> SeperableTMap:
    """Find the linear force map minimizing the mean squared mapped force.

    Arguments mirror the reference entry point; ``solver_args`` accepts (and
    ignores) reference OSQP options plus the options documented on
    :class:`SolverOptions`. ``device`` (default: the GPU, or the device of
    tensor forces) is where the device backend runs; "auto" takes it for
    every fit that is not on the CPU, float64 forces included. Tensor
    forces give maps that apply as torch code on their
    device (``TLinearMap``); numpy forces give numpy ``LinearMap`` maps.

    ``mesh`` (``parallel.make_mesh``; every rank calls with all the forces)
    shards the device fit's frames: each rank uploads and reduces its share,
    one all-reduce sums the Grams, and the solve and its float64 escalation
    run replicated, so every rank returns the same map (the JAX package's
    ``sharded_linear_fit`` route). The host backend is single-process and
    ignores it.
    """
    fm = as_frame_mesh(mesh) if mesh is not None else None
    if fm is not None:
        device = mesh_device(fm, device)
    if constraints is None:
        constraints = set()
    opts = _solver_opts(dict(solver_args) if solver_args else None)
    labels, reduced_n = constraint_labels(coord_map.n_fg_sites, constraints)

    def con_mat() -> np.ndarray:
        # dense duplication matrix, built only on the paths that consume it
        # (host/escalation) — at sweep scale it is a ~50 MB host
        # allocation the label-based device path never needs
        return _dense_from_labels(labels, reduced_n)

    forces = traj.forces
    out_dtype = _numpy_dtype(forces)
    backend = opts.get("backend", "auto")
    if backend == "auto":
        # float64 forces take the float64 host fit only when the caller
        # runs on the CPU; on the card they stay there, in float64
        on_cpu = resolve_device(device, forces).type == "cpu"
        backend = "host" if out_dtype == np.float64 and on_cpu else "device"

    if backend == "host":
        fmap_mat = _host_linear_fit(
            _host_array(forces),
            con_mat(),
            coord_map.standard_matrix,
            l2_regularization,
            delta=opts.get("delta", 1e-12),
            refine_iters=opts.get("refine_iters", 4),
        ).astype(out_dtype)
        fit_routes["host"] += 1
    else:
        dev = resolve_device(device, forces)
        fit_dtype = torch.float64 if out_dtype == np.float64 else torch.float32
        if fm is None:
            forces_dev = torch.as_tensor(forces, device=dev).to(fit_dtype)
        else:
            forces_dev = shard_frames(fm, [forces], pad=False, dtype=fit_dtype)[0]
        fmap_dev, resid_dev = _device_linear_fit(
            forces_dev,
            torch.as_tensor(labels, dtype=torch.int64, device=dev),
            torch.as_tensor(
                np.asarray(coord_map.standard_matrix), dtype=fit_dtype, device=dev
            ),
            float(l2_regularization),
            r=reduced_n,
            reduce=None if fm is None else fm.all_reduce,
        )
        fmap_mat = fmap_dev.cpu().numpy()
        resid_val = float(resid_dev)
        fit_routes["device"] += 1
        if not converged(resid_val, opts.get("resid_tol", 1e-4), fmap_mat):
            # convergence check failed (non-finite, or equilibrated
            # constraint violation above tolerance — the analogue of OSQP's
            # eps_abs termination + polish in the reference): escalate to
            # the float64 LAPACK twin
            fit_routes["escalated"] += 1
            with span("aggforce.escalate"):
                fmap_mat = _host_linear_fit(
                    _host_array(forces),
                    con_mat(),
                    coord_map.standard_matrix,
                    l2_regularization,
                ).astype(fmap_mat.dtype)
    if isinstance(forces, torch.Tensor):
        # tensor input -> maps applied as torch code on that device, so
        # downstream application never round-trips trajectory-sized arrays
        return SeperableTMap(
            coord_map=TLinearMap.from_linearmap(coord_map, device=forces.device),
            force_map=TLinearMap(fmap_mat, device=forces.device),
        )
    return SeperableTMap(coord_map=coord_map, force_map=LinearMap(fmap_mat))


def constraint_labels(
    n_sites: int, constraints: Constraints
) -> Tuple[np.ndarray, int]:
    """Site -> reduced-coefficient column labels, plus the reduced dimension.

    The integer form of the duplication matrix C (``C = one_hot(labels)``):
    sites in the same (merged) constraint group share one column; columns
    are ordered by each anchor's position among unconstrained sites
    (reference qp/qplinear.py:106-164 semantics). Device fits upload these
    labels and never build C.
    """
    groups = reduce_constraint_sets(constraints)
    lookup = constraint_lookup_dict(groups)
    labels = np.full(n_sites, -1, dtype=np.int32)
    col = 0
    for site in range(n_sites):
        if site not in lookup:
            labels[site] = col
            col += 1
    for site, anchor in lookup.items():
        labels[site] = labels[anchor]
    return labels, col


def _dense_from_labels(labels: np.ndarray, reduced_n: int) -> np.ndarray:
    """Dense duplication matrix C = one_hot(labels) (single source of truth)."""
    mat = np.zeros((labels.shape[0], reduced_n))
    mat[np.arange(labels.shape[0]), labels] = 1.0
    return mat


def make_bond_constraint_matrix(n_sites: int, constraints: Constraints) -> np.ndarray:
    """Duplication matrix C mapping reduced coefficients to per-site ones.

    Dense form of :func:`constraint_labels` (kept for the host paths and
    reference-parity call sites).
    """
    labels, reduced_n = constraint_labels(n_sites, constraints)
    return _dense_from_labels(labels, reduced_n)


def _labels_from_con_mat(con_mat: np.ndarray) -> np.ndarray:
    """The labels of a one-hot duplication matrix C (its column of each
    site); ValueError unless C is exactly ``one_hot(labels)``."""
    con_mat = np.asarray(con_mat)
    labels = np.argmax(con_mat, axis=1) if con_mat.ndim == 2 else None
    if labels is None or not np.array_equal(
        con_mat, _dense_from_labels(labels, con_mat.shape[1])
    ):
        raise ValueError(
            "con_mat must be a one-hot duplication matrix "
            "(make_bond_constraint_matrix), one 1 in each row"
        )
    return labels


def sharded_linear_fit(
    forces,
    con_mat: np.ndarray,
    cmap_mat: np.ndarray,
    l2_regularization: float = 0.0,
    mesh=None,
    return_resid: bool = False,
):
    """Fit the optimal linear force-map matrix with frames sharded on a mesh.

    The device fit of :func:`qp_linear_map` with ``mesh``, on a duplication
    matrix ``con_mat`` (``make_bond_constraint_matrix``; one that is not
    one-hot raises ValueError) instead of constraints: each rank reduces its share
    of the frames, one all-reduce sums the Grams, and the solve runs on
    every rank, in the forces' float dtype at full float32 precision. It
    returns the (n_cg, n_fg) map as numpy on every rank, without the
    float64 escalation. ``mesh`` None is ``parallel.make_mesh()``. With
    ``return_resid=True`` also returns the solver's equilibrated constraint
    violation, the diagnostic callers check before trusting a float32 solve.
    """
    labels = _labels_from_con_mat(con_mat)
    fm = as_frame_mesh(make_mesh() if mesh is None else mesh)
    dtype = torch.float64 if _numpy_dtype(forces) == np.float64 else torch.float32
    local = shard_frames(fm, [forces], pad=False, dtype=dtype)[0]
    fmap_dev, resid_dev = _device_linear_fit(
        local,
        torch.as_tensor(labels, dtype=torch.int64, device=fm.device),
        torch.as_tensor(np.asarray(cmap_mat), dtype=dtype, device=fm.device),
        float(l2_regularization),
        r=np.asarray(con_mat).shape[1],
        reduce=fm.all_reduce,
    )
    fetched = torch.cat([fmap_dev.reshape(-1), resid_dev.reshape(1)]).cpu().numpy()
    fmap_mat = fetched[:-1].reshape(fmap_dev.shape)
    if return_resid:
        return fmap_mat, float(fetched[-1])
    return fmap_mat
