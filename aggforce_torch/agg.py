r"""Top-level orchestration: optimal force aggregation and cross validation.

Counterpart of the JAX package's ``agg.py``. Behavior parity target:
reference agg.py:49-343 — ``project_forces`` (auto constraint detection,
method dispatch, result-dict packaging), ``project_forces_grid_cv`` (k-fold
CV over a kwargs grid), and ``force_smoothness``. As in the JAX package, the
CV loop maps the holdout data with the real ``map_arrays`` method (the
reference calls a non-existent ``TMap.from_arrays``, agg.py:224).
"""

import copy
from gc import collect
from itertools import product
from typing import (
    Any,
    Callable,
    Collection,
    Dict,
    Final,
    List,
    Mapping,
    NamedTuple,
    Optional,
    Tuple,
    TypeVar,
    Union,
)

import numpy as np
import torch

from .constraints import Constraints, guess_pairwise_constraints
from .map import LinearMap, TMap
from .qp import qp_linear_map
from .trajectory import Trajectory
from .utils.prof import span

PROJECT_FORCES_CNSTR_AUTO: Final = "auto"

SCORES_KNAME: Final = "scores"
SDS_KNAME: Final = "sds"
NRUNS_KNAME: Final = "n_runs"

PROJFORCES_KNAME: Final = "mapped_forces"
PROJCOORDS_KNAME: Final = "mapped_coords"
TMAP_KNAME: Final = "tmap"
RESIDUAL_KNAME: Final = "residual"
CONSTRAINTS_KNAME: Final = "constraints"


@span("aggforce.entry")
def project_forces(
    coords,
    forces,
    coord_map: LinearMap,
    constrained_inds: Union[Constraints, str, None] = PROJECT_FORCES_CNSTR_AUTO,
    method: Callable[..., TMap] = qp_linear_map,
    **kwargs,
) -> Dict[str, Any]:
    r"""Derive an optimized force map and apply it.

    Arguments:
    ---------
    coords:
        (n_frames, n_sites, n_dim) positions, numpy or a torch tensor. For
        linear maps these only matter for constraint auto-detection.
    forces:
        (n_frames, n_sites, n_dim) forces.
    coord_map:
        LinearMap fixing the configurational fg -> cg map.
    constrained_inds:
        Set of frozensets of constrained site groups, or "auto" to detect
        pairwise constraints from coordinate fluctuations (on
        ``kwargs["device"]``: the GPU by default, or the device of tensor
        coordinates).
    method:
        Map builder (e.g. qp_linear_map, constraint_aware_uni_map,
        qp_feat_linear_map); receives traj/coord_map/constraints plus
        ``kwargs`` (``device=None`` there means the GPU).

    Returns:
    -------
    Dict with mapped_coords, mapped_forces, tmap, residual (force_smoothness
    of the mapped forces — computed in-sample), and constraints.
    """
    if isinstance(constrained_inds, str):
        if constrained_inds != PROJECT_FORCES_CNSTR_AUTO:
            raise ValueError(f"Unknown constraint mode '{constrained_inds}'.")
        if coords is None or not hasattr(coords, "shape"):
            raise ValueError(
                f"If constrained_inds is {PROJECT_FORCES_CNSTR_AUTO}, coords "
                "cannot be None."
            )
        constrained_inds = guess_pairwise_constraints(
            coords, device=kwargs.get("device")
        )
    t = Trajectory(coords=coords, forces=forces)
    traj_map: TMap = method(
        traj=t,
        coord_map=coord_map,
        constraints=constrained_inds,
        **kwargs,
    )
    mapped = traj_map(t)
    return {
        PROJCOORDS_KNAME: mapped.coords,
        PROJFORCES_KNAME: mapped.forces,
        TMAP_KNAME: traj_map,
        RESIDUAL_KNAME: force_smoothness(mapped.forces),
        CONSTRAINTS_KNAME: constrained_inds,
    }


T = TypeVar("T")


def project_forces_grid_cv(
    cv_arg_dict: Mapping[str, List[T]],
    coords,
    forces,
    n_folds: int = 5,
    rng: Optional[np.random.Generator] = None,
    fast: Union[bool, str] = "auto",
    **kwargs,
) -> Dict[str, Dict[NamedTuple, Any]]:
    """K-fold cross validation of ``project_forces`` over a parameter grid.

    For each point of the grid implied by ``cv_arg_dict`` (cartesian product
    over each key's value list), fits on the training folds and scores
    ``force_smoothness`` on the holdout fold. Returns per-grid-point mean
    scores, sample standard deviations, and completed run counts.

    ``rng`` makes the fold shuffle reproducible. When the grid varies only
    ``l2_regularization`` and the method is the linear optimizer, or
    ``featurizer`` and/or ``l2_regularization`` and the method is the
    canonical featurized one (``qp_feat_linear_map`` with id+gb
    featurizers), ``fast="auto"`` dispatches to the single-pass CV
    (:func:`aggforce_torch.qp.cv.linear_map_cv`,
    :func:`aggforce_torch.qp.cv.fused_gb_cv_grid`): every (fold, l2) fit
    reuses one set of per-fold Gram matrices and holdout scores are
    computed algebraically — the same results, one trajectory pass (per
    featurizer) instead of n_folds * n_grid refits. ``fast=True`` raises
    ValueError for a grid with no single-pass path.
    """
    if fast:
        dispatched = _fast_grid_cv(
            cv_arg_dict, coords, forces, n_folds, rng, kwargs
        )
        if dispatched is not None:
            return dispatched
        if fast is True:
            raise ValueError(
                "fast=True requested but this grid/method combination has "
                "no single-pass CV path."
            )
    n_frames = forces.shape[0]
    frames = np.arange(n_frames)
    (rng if rng is not None else np.random.default_rng()).shuffle(frames)
    fold_inds = np.array_split(frames, n_folds)
    train_inds = [
        np.concatenate([x for j, x in enumerate(fold_inds) if j != i])
        for i in range(len(fold_inds))
    ]

    results: Dict[str, Dict[Any, Any]] = {
        SCORES_KNAME: {},
        SDS_KNAME: {},
        NRUNS_KNAME: {},
    }
    for label, grid_kwargs in process_cvargs(cv_arg_dict):
        fold_scores: List[float] = []
        combined = dict(kwargs, **grid_kwargs)
        for tr, val in zip(train_inds, fold_inds):
            try:
                tmap = project_forces(
                    coords=coords[tr], forces=forces[tr], **combined
                )[TMAP_KNAME]
                _, val_forces = tmap.map_arrays(
                    coords=coords[val], forces=forces[val]
                )
                fold_scores.append(force_smoothness(val_forces))
                del tmap
            except ValueError as e:
                print(e)
            collect()
        results[SCORES_KNAME][label] = mean(fold_scores)
        results[SDS_KNAME][label] = sample_sd(fold_scores)
        results[NRUNS_KNAME][label] = len(fold_scores)
    return results


def _fast_grid_cv(
    cv_arg_dict: Mapping[str, List[Any]],
    coords,
    forces,
    n_folds: int,
    rng: Optional[np.random.Generator],
    kwargs: Dict[str, Any],
) -> Optional[Dict[str, Dict[NamedTuple, Any]]]:
    """Dispatch to a single-pass CV implementation when one applies, else None.

    Covered grids: {l2_regularization} for the linear and canonical
    featurized methods, and {featurizer[, l2_regularization]} for the
    canonical featurized method (every featurizer in the grid must be
    recognized as a canonical id+gb featurization).
    """
    keys = set(cv_arg_dict.keys())
    if not keys or not keys <= {"l2_regularization", "featurizer"}:
        return None
    kw = dict(kwargs)
    method = kw.pop("method", qp_linear_map)
    coord_map = kw.pop("coord_map", None)
    if coord_map is None:
        return None
    constrained = kw.pop("constrained_inds", PROJECT_FORCES_CNSTR_AUTO)
    device = kw.pop("device", None)

    from .qp.cv import _fold_segments, fused_gb_cv_grid, linear_map_cv
    from .qp.featlinearmap import qp_feat_linear_map
    from .qp.fusedfeat import recognize_canonical_featurizer

    mesh = kw.pop("mesh", None)
    grid_feats = list(cv_arg_dict.get("featurizer", []))
    if "l2_regularization" in keys:
        l2_values = list(cv_arg_dict["l2_regularization"])
    else:
        l2_values = [kw.pop("l2_regularization", 1e1)]
    use_linear = method is qp_linear_map and not kw and not grid_feats
    specs = kbt = None
    n_cf = 20
    if not use_linear:
        if method is not qp_feat_linear_map:
            return None
        kbt = kw.pop("kbt", None)
        n_cf = kw.pop("n_constraint_frames", 20)
        featurizers = grid_feats or [kw.pop("featurizer", None)]
        kw.pop("featurizer", None)
        specs = [recognize_canonical_featurizer(f) for f in featurizers]
        if any(s is None for s in specs) or kbt is None or kw:
            return None

    # materialize the generator ONCE so the eligibility probe, the fast CV,
    # and (on fallback) the generic refit loop all draw the same fold partition
    # — with rng=None a fresh generator per consumer would let the probe
    # validate folds the CV never uses
    if rng is None:
        rng = np.random.default_rng()

    if isinstance(constrained, str):
        if constrained != PROJECT_FORCES_CNSTR_AUTO:
            return None
        constrained = guess_pairwise_constraints(coords, device=device)
        # the generic refit loop re-detects constraints per fold on TRAINING
        # frames only; the single-pass implementation needs one constraint
        # set for the shared Gram geometry. Use the fast path only when
        # per-train-fold detection agrees with the full-trajectory set —
        # otherwise fall back to the generic (per-fold) refit loop so results
        # stay identical. Folds are probed on a COPY of the rng so the
        # downstream CV draws the same partition it would have anyway.
        # The per-fold sds come from ONE moment pass (total minus fold);
        # only when some pair sits within the probe's arithmetic margin of
        # the threshold does the exact per-fold detection run.
        from .constraints.finder import fold_train_constraint_probe

        probe_rng = copy.deepcopy(rng)
        probe_folds = _fold_segments(len(coords), n_folds, probe_rng)
        predicted = fold_train_constraint_probe(coords, probe_folds, device=device)
        if predicted is None:
            # near-threshold ambiguity (rare): exact per-fold detection
            for held in probe_folds:
                train_idx = np.setdiff1d(np.arange(len(coords)), held)
                if (
                    guess_pairwise_constraints(coords[train_idx], device=device)
                    != constrained
                ):
                    return None
        else:
            for fold_set in predicted:
                if fold_set != constrained:
                    return None

    results: Dict[str, Dict[Any, Any]] = {
        SCORES_KNAME: {},
        SDS_KNAME: {},
        NRUNS_KNAME: {},
    }
    if use_linear:
        raw = linear_map_cv(
            coords, forces, coord_map, constrained,
            l2_values=l2_values, n_folds=n_folds, rng=rng, mesh=mesh, device=device,
        )
        CVArgs = NamedTuple("CVArgs", [("l2_regularization", Any)])  # type: ignore[misc]
        for l2 in l2_values:
            mean_score, sd, n = raw[float(l2)]
            label = CVArgs(l2_regularization=l2)
            results[SCORES_KNAME][label] = mean_score
            results[SDS_KNAME][label] = sd
            results[NRUNS_KNAME][label] = n
        return results

    raw_grid = fused_gb_cv_grid(
        coords, forces, coord_map, constrained, kbt=kbt, specs=specs,
        l2_values=l2_values, n_folds=n_folds, n_constraint_frames=n_cf, rng=rng,
        mesh=mesh, device=device,
    )
    # labels mirror the generic refit loop: one namedtuple field per grid
    # key in cv_arg_dict order (process_cvargs), holding the grid's own
    # values (featurizer objects, not specs)
    names = list(cv_arg_dict.keys())
    CVArgs = NamedTuple("CVArgs", [(n, Any) for n in names])  # type: ignore[misc]
    for fi in range(len(grid_feats)) if grid_feats else [0]:
        for l2 in l2_values:
            mean_score, sd, n = raw_grid[(fi, float(l2))]
            fields = {}
            if "featurizer" in keys:
                fields["featurizer"] = grid_feats[fi]
            if "l2_regularization" in keys:
                fields["l2_regularization"] = l2
            label = CVArgs(**fields)
            results[SCORES_KNAME][label] = mean_score
            results[SDS_KNAME][label] = sd
            results[NRUNS_KNAME][label] = n
    return results


def process_cvargs(
    arg_dict: Mapping[str, List[Any]]
) -> List[Tuple[NamedTuple, Dict[str, Any]]]:
    """Expand {name: [values...]} into a labeled grid of kwarg dicts.

    Each grid point is returned as (namedtuple label, kwargs dict); the
    namedtuple type has one field per parameter name so labels are hashable
    and self-describing.
    """
    names = list(arg_dict.keys())
    value_lists = [arg_dict[name] for name in names]
    CVArgs = NamedTuple("CVArgs", [(n, Any) for n in names])  # type: ignore[misc]
    out: List[Tuple[NamedTuple, Dict[str, Any]]] = []
    for combo in product(*value_lists):
        label = CVArgs(**dict(zip(names, combo)))
        out.append((label, dict(zip(names, combo))))
    return out


def force_smoothness(array) -> float:
    """Mean squared element — the force-map quality residual.

    Tensors reduce on their device and fetch one scalar, so scoring a
    device-resident mapped trajectory does not pull the whole array to host.
    """
    if isinstance(array, torch.Tensor):
        return float(torch.mean(torch.square(array)))
    return float(np.mean(np.asarray(array) ** 2))


def mean(s: Collection[float]) -> Optional[float]:
    """Arithmetic mean; None on empty input."""
    if len(s) == 0:
        return None
    return sum(s) / len(s)


def sample_sd(s: Collection[float]) -> Optional[float]:
    """Sample standard deviation; None on empty input."""
    m = mean(s)
    if m is None or len(s) < 2:
        return None
    return (sum((o - m) ** 2 for o in s) / (len(s) - 1)) ** 0.5
