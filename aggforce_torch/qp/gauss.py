"""Optimized stochastic (Gaussian-noised) coordinate-force maps.

Counterpart of the JAX package's ``qp/jgauss.py``. Behavior parity targets:
reference qp/jgauss.py:27-140 (``joptgauss_map``), :143-312
(``stagedjoptgauss_map``), :315-446 (``stagedjslicegauss_map``), :449-650
(``stagedjforcegauss_map``). The flow of each builder matches the
reference; noising and log-gradient evaluation run through
:class:`aggforce_torch.trajectory.TCondNormal` (closed-form gradients) and
the force-map fits through :func:`aggforce_torch.qp.qp_linear_map`.

Math note (mirrors reference jgauss.py:266-309): for a linear coordinate map
A and CG-level noise force f, A^T f back-maps the noise force to the
atomistic resolution (since grad_x f(Ax) = A^T [grad f](Ax)), so
``force_map @ coord_map.T`` as a source_postmap turns augmenter corrections
into already-coarse-grained force corrections.

Every builder takes ``device`` (None: the device of tensor trajectories,
else the GPU). Tensor trajectories stay on their device and give maps that
apply there; float64 tensors are augmented and fitted in float64.
"""

import logging
import os
import warnings
from typing import Optional

import numpy as np
import torch

from ..constraints import Constraints
from ..map import (
    AugmentedTMap,
    ComposedTMap,
    LinearMap,
    NullForcesTMap,
    RATMap,
    SeperableTMap,
    TLinearMap,
    lmap_augvariables,
)
from ..parallel.mesh import agree_seed, as_frame_mesh, mesh_device
from ..trajectory import (
    AugmentedTrajectory,
    CoordsTrajectory,
    TCondNormal,
    Trajectory,
)
from ..utils.device import DeviceLike, resolve_device
from .basicagg import constraint_aware_uni_map
from .qplinear import DEFAULT_SOLVER_OPTIONS, SolverOptions, fit_routes, qp_linear_map

logger = logging.getLogger(__name__)


def _noise_site_slice_map(n_total_sites: int, n_aug_sites: int) -> LinearMap:
    """LinearMap isolating the trailing ``n_aug_sites`` of a mapped system."""
    preserved = [[i] for i in range(n_total_sites - n_aug_sites, n_total_sites)]
    return LinearMap(mapping=preserved, n_fg_sites=n_total_sites)


def _mesh_seed(mesh, seed, device):
    """(mesh, seed, device) of a builder called with ``mesh``: the checked
    mesh, rank 0's seed (so every rank draws the same noise) and the mesh's
    device. Without a mesh, the arguments as given."""
    if mesh is None:
        return None, seed, device
    fm = as_frame_mesh(mesh)
    return fm, agree_seed(fm, seed), mesh_device(fm, device)


def _given_premap(coord_map: LinearMap, force_map: LinearMap, traj, dev) -> SeperableTMap:
    """The premap of a caller-given force map; torch maps for tensor data."""
    if isinstance(traj.coords, torch.Tensor):
        return SeperableTMap(
            coord_map=TLinearMap.from_linearmap(coord_map, device=dev),
            force_map=TLinearMap.from_linearmap(force_map, device=dev),
        )
    return SeperableTMap(coord_map=coord_map, force_map=force_map)


def joptgauss_map(
    traj: Trajectory,
    coord_map: LinearMap,
    var: float,
    kbt: float,
    constraints: Optional[Constraints] = None,
    seed: Optional[int] = None,
    device: DeviceLike = None,
    **kwargs,
) -> AugmentedTMap:
    """Optimized single-stage Gaussian map.

    Adds Gaussian noise to the coordinate-mapped positions as virtual
    particles, optimizes a linear force map on the augmented system that
    isolates the virtual sites, and wraps it so application re-noises fresh
    input trajectories. The result is stochastic and non-separable.

    A ``mesh`` in ``kwargs`` goes to the fit (``qp_linear_map``), and every
    rank draws rank 0's seed.
    """
    fm, seed, device = _mesh_seed(kwargs.get("mesh"), seed, device)
    if fm is not None:
        kwargs["mesh"] = fm
    dev = resolve_device(device, traj.coords, traj.forces)
    flattened_cmap = TLinearMap.from_linearmap(
        coord_map, bypass_nan_check=True, device=dev
    ).flat_call
    augmenter = TCondNormal(cov=var, premap=flattened_cmap, seed=seed, device=dev)
    aug_traj = AugmentedTrajectory.from_trajectory(t=traj, augmenter=augmenter, kbt=kbt)
    aug_coord_map = lmap_augvariables(aug_traj)
    # constraint indices refer to the leading (real) block of the augmented
    # system, so they remain valid unmodified.
    aug_tmap = qp_linear_map(
        traj=aug_traj, coord_map=aug_coord_map, constraints=constraints,
        device=dev, **kwargs,
    )
    return AugmentedTMap(aug_tmap=aug_tmap, augmenter=augmenter, kbt=kbt)


def _try_staged_fused(
    traj,
    coord_map,
    var,
    kbt,
    force_map,
    constraints,
    seed,
    premap_l2_regularization,
    premap_solver_args,
    kwargs,
    zero_stage2: bool,
    mesh=None,
):
    """Take the one-sync staged fits when they apply (with ``mesh``, their
    frames sharded over the ranks).

    Conditions: float32 tensor trajectory, device-eligible solver options,
    and second-stage kwargs limited to l2/solver knobs. Returns (pre_tmap,
    post_tmap, remaining) or None (callers then run the piecewise path,
    which owns the float64 escalation). ``AGGFORCE_STAGED_FUSED=0`` opts
    out. ``qplinear.fit_routes`` counts "staged_fused" for each fused fit
    and "staged_fused_missed" for each that fell back after a solve missed
    its tolerance.
    """
    if os.environ.get("AGGFORCE_STAGED_FUSED", "1") != "1":
        return None  # explicit opt-out (parity testing / debugging)
    if set(kwargs) - {"l2_regularization", "solver_args"}:
        return None
    pre_opts = premap_solver_args or {}
    post_opts = kwargs.get("solver_args") or {}
    if pre_opts.get("backend", "auto") not in ("auto", "device"):
        return None
    if post_opts.get("backend", "auto") not in ("auto", "device"):
        return None
    # custom solver tuning (delta/refine_iters) is honored only by the
    # piecewise fits; the fused fits run the default device solver
    for opts in (pre_opts, post_opts):
        if set(opts) - {"backend", "resid_tol"}:
            return None
    forces = traj.forces
    if not isinstance(forces, torch.Tensor) or forces.dtype == torch.float64:
        return None

    from .gauss_fused import staged_gauss_fused

    fused = staged_gauss_fused(
        traj,
        coord_map,
        var=var,
        kbt=kbt,
        force_map=force_map,
        constraints=constraints,
        seed=seed,
        premap_l2_regularization=premap_l2_regularization,
        l2_regularization=kwargs.get("l2_regularization", 0.0),
        zero_stage2=zero_stage2,
        resid_tol=min(
            pre_opts.get("resid_tol", 1e-4), post_opts.get("resid_tol", 1e-4)
        ),
        mesh=mesh,
    )
    if fused is None:
        fit_routes["staged_fused_missed"] += 1
        logger.warning(
            "staged Gaussian fit: a float32 solve missed its tolerance; "
            "re-running the piecewise fits, which escalate to float64"
        )
        return None
    fit_routes["staged_fused"] += 1
    pre_tmap, pmapped_tmap, remaining = fused
    post_tmap = _post_map(pre_tmap, pmapped_tmap, var, kbt, seed, forces.device)
    return pre_tmap, post_tmap, remaining


def _post_map(pre_tmap, pmapped_tmap, var, kbt, seed, dev) -> AugmentedTMap:
    """The noising second stage of a staged map: its augmenter maps the
    noise correction with ``force_map @ coord_map.T`` of the premap."""
    t_coord_map = TLinearMap.from_linearmap(
        pre_tmap.coord_map, bypass_nan_check=True, device=dev
    )
    t_force_map = TLinearMap.from_linearmap(
        pre_tmap.force_map, bypass_nan_check=True, device=dev
    )
    augmenter = TCondNormal(
        cov=var, source_postmap=(t_force_map @ t_coord_map.T), seed=seed, device=dev
    )
    return AugmentedTMap(aug_tmap=pmapped_tmap, augmenter=augmenter, kbt=kbt)


def _staged_piecewise(
    traj, coord_map, var, kbt, force_map, constraints, seed,
    premap_l2_regularization, premap_solver_args, dev, kwargs, zero_stage2: bool,
    mesh=None,
):
    """The piecewise staged fits: (pre_tmap, pmapped_traj, pmapped_tmap);
    ``mesh`` shards the premap fit."""
    if force_map is None:
        pre_tmap = qp_linear_map(
            traj=traj,
            coord_map=coord_map,
            constraints=constraints,
            l2_regularization=premap_l2_regularization,
            solver_args=premap_solver_args,
            mesh=mesh,
            device=dev,
        )
    else:
        pre_tmap = _given_premap(coord_map, force_map, traj, dev)
    premap = TLinearMap.from_linearmap(pre_tmap.coord_map, bypass_nan_check=True, device=dev)
    augmenter = TCondNormal(cov=var, premap=premap.flat_call, seed=seed, device=dev)
    if zero_stage2:
        forces = traj.forces
        zero = torch.zeros_like(forces) if isinstance(forces, torch.Tensor) else np.zeros_like(forces)
        traj = Trajectory(coords=traj.coords, forces=zero)
    aug_traj = AugmentedTrajectory.from_trajectory(t=traj, augmenter=augmenter, kbt=kbt)
    # coarse-grain only the real block, keeping the virtual sites
    pmapped_traj = RATMap(tmap=pre_tmap)(aug_traj)
    pmapped_coord_map = _noise_site_slice_map(pmapped_traj.n_sites, aug_traj.n_aug_sites)
    # constraints are assumed mapped away by any reasonable premap
    pmapped_tmap = qp_linear_map(
        traj=pmapped_traj, coord_map=pmapped_coord_map, constraints=set(),
        device=dev, **kwargs,
    )
    return pre_tmap, pmapped_traj, pmapped_tmap


def stagedjoptgauss_map(
    traj: Trajectory,
    coord_map: LinearMap,
    var: float,
    kbt: float,
    force_map: Optional[LinearMap] = None,
    constraints: Optional[Constraints] = None,
    seed: Optional[int] = None,
    premap_l2_regularization: float = 0.0,
    premap_solver_args: Optional[SolverOptions] = None,
    mesh=None,
    device: DeviceLike = None,
    **kwargs,
) -> ComposedTMap:
    """Two-stage Gaussian map: deterministic premap, then noising map.

    Returns ComposedTMap([post, pre]): ``pre`` (index 1) linearly
    coarse-grains coords and forces; ``post`` (index 0) noises the
    already-mapped data and mixes in noise-derived forces. Data can be
    mapped with ``pre``, stored, and later finished with ``post``.

    float32 tensor trajectories take the one-sync fits
    (:mod:`aggforce_torch.qp.gauss_fused`): both fits, the noise draw and
    the real-block premapping are enqueued back to back and read once,
    instead of waiting on each fit and map application.

    With ``mesh`` (``parallel.make_mesh``) every rank draws rank 0's seed;
    the one-sync fits shard their frames over the ranks (both fits' Grams
    and the noise check are summed by all-reduces), and the piecewise path
    shards its premap fit, as the JAX package's does.
    """
    fm, seed, device = _mesh_seed(mesh, seed, device)
    dev = resolve_device(device, traj.coords, traj.forces)
    if premap_solver_args is None:
        premap_solver_args = DEFAULT_SOLVER_OPTIONS
    fused = _try_staged_fused(
        traj, coord_map, var, kbt, force_map, constraints, seed,
        premap_l2_regularization, premap_solver_args, kwargs, zero_stage2=False,
        mesh=fm,
    )
    if fused is not None:
        pre_tmap, post_tmap, _ = fused
        return ComposedTMap(submaps=[post_tmap, pre_tmap])
    pre_tmap, _, pmapped_tmap = _staged_piecewise(
        traj, coord_map, var, kbt, force_map, constraints, seed,
        premap_l2_regularization, premap_solver_args, dev, kwargs, zero_stage2=False,
        mesh=fm,
    )
    post_tmap = _post_map(pre_tmap, pmapped_tmap, var, kbt, seed, dev)
    return ComposedTMap(submaps=[post_tmap, pre_tmap])


def stagedjslicegauss_map(
    traj: CoordsTrajectory,
    coord_map: LinearMap,
    var: float,
    kbt: float,
    seed: Optional[int] = None,
    constraints: Optional[Constraints] = None,  # noqa: ARG001
    warn_input_forces: bool = True,
    device: DeviceLike = None,
) -> ComposedTMap:
    """Gaussian map reporting only noise-derived forces.

    The returned ComposedTMap has three stages: [2] fills (or replaces)
    forces with NaN so coordinate-only data flows, [1] coarse-grains the
    coordinates (with an all-ones dummy force map), [0] noises and slices out
    the noise sites and their forces. Input force data is ignored
    (optionally with a warning).
    """
    dev = resolve_device(device, traj.coords)
    naforce_traj = NullForcesTMap(warn_input_forces=warn_input_forces)(traj)
    augmenter = TCondNormal(
        cov=var,
        premap=TLinearMap.from_linearmap(
            coord_map, bypass_nan_check=True, device=dev
        ).flat_call,
        seed=seed,
        device=dev,
    )
    aug_traj = AugmentedTrajectory.from_trajectory(
        t=naforce_traj, augmenter=augmenter, kbt=kbt
    )
    null_fmap = LinearMap(
        mapping=np.ones_like(coord_map.standard_matrix), handle_nans=False
    )
    pre_tmap = _given_premap(coord_map, null_fmap, traj, dev)
    pmapped_traj = RATMap(tmap=pre_tmap)(aug_traj)
    pmapped_coord_map = _noise_site_slice_map(
        pmapped_traj.n_sites, aug_traj.n_aug_sites
    )
    pmapped_tmap = constraint_aware_uni_map(
        traj=pmapped_traj, coord_map=pmapped_coord_map, constraints=set()
    )
    pmapped_augmenter = TCondNormal(cov=var, seed=seed, device=dev)
    post_tmap = AugmentedTMap(
        aug_tmap=pmapped_tmap, augmenter=pmapped_augmenter, kbt=kbt
    )
    return ComposedTMap(
        submaps=[post_tmap, pre_tmap, NullForcesTMap(warn_input_forces=False)]
    )


def _mean_square_mapped(force_map, forces) -> float:
    """Mean square of ``force_map(forces)`` with one host read for tensors
    (the value and the map's NaN verdict come back together)."""
    if isinstance(force_map, TLinearMap) and isinstance(forces, torch.Tensor):
        mapped, bad = force_map._apply(forces)
        raise_nan = force_map.handle_nans and not force_map.bypass_nan_check
        both = torch.stack(
            [torch.mean(torch.square(mapped)), (bad.to(mapped.device) & raise_nan).to(mapped.dtype)]
        ).cpu()
        if bool(both[1]):
            force_map(forces)  # raises the map's own NaN error
        return float(both[0])
    return float(np.mean(np.asarray(force_map(forces)) ** 2))


def stagedjforcegauss_map(
    traj: Trajectory,
    coord_map: LinearMap,
    var: float,
    kbt: float,
    force_map: Optional[LinearMap] = None,
    constraints: Optional[Constraints] = None,
    seed: Optional[int] = None,
    premap_l2_regularization: float = 0.0,
    premap_solver_args: Optional[SolverOptions] = None,
    contribution_tolerance: float = 1e-6,
    device: DeviceLike = None,
    **kwargs,
) -> ComposedTMap:
    """Staged Gaussian map minimizing noise-force contributions.

    Mirrors :func:`stagedjoptgauss_map`, but the second-stage optimization
    runs on a zero-force copy of the input so it minimizes *only* the
    noise-derived force signal; if the optimizer cannot cancel it below
    ``contribution_tolerance`` a warning is emitted. float32 tensor
    trajectories take the one-sync fits, with the noise contribution
    computed beside them.

    A ``mesh`` in ``kwargs`` goes to the second-stage fit alone, as in the
    JAX package (the one-sync fits then do not apply), and every rank draws
    rank 0's seed.
    """
    fm, seed, device = _mesh_seed(kwargs.get("mesh"), seed, device)
    if fm is not None:
        kwargs["mesh"] = fm
    dev = resolve_device(device, traj.coords, traj.forces)
    if premap_solver_args is None:
        premap_solver_args = DEFAULT_SOLVER_OPTIONS
    fused = _try_staged_fused(
        traj, coord_map, var, kbt, force_map, constraints, seed,
        premap_l2_regularization, premap_solver_args, kwargs, zero_stage2=True,
    )
    if fused is not None:
        pre_tmap, post_tmap, remaining = fused
    else:
        pre_tmap, pmapped_traj, pmapped_tmap = _staged_piecewise(
            traj, coord_map, var, kbt, force_map, constraints, seed,
            premap_l2_regularization, premap_solver_args, dev, kwargs,
            zero_stage2=True,
        )
        remaining = _mean_square_mapped(pmapped_tmap.force_map, pmapped_traj.forces)
        post_tmap = _post_map(pre_tmap, pmapped_tmap, var, kbt, seed, dev)
    if remaining > contribution_tolerance:
        warnings.warn(
            "Unable to remove all noise contributions in forces. Remaining "
            f"contribution: {remaining}.",
            stacklevel=2,
        )
    return ComposedTMap(submaps=[post_tmap, pre_tmap])
