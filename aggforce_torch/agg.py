r"""Top-level orchestration: optimal force aggregation.

Counterpart of the JAX package's ``agg.py`` (``project_forces`` and
``force_smoothness``). Behavior parity target: reference agg.py:49-343.
Cross-validation (``project_forces_grid_cv``) waits for ROADMAP Queue 1
item 8.
"""

from typing import Any, Callable, Dict, Final, Optional, Union

import numpy as np
import torch

from .constraints import Constraints
from .map import LinearMap, TMap
from .trajectory import Trajectory

PROJECT_FORCES_CNSTR_AUTO: Final = "auto"

PROJFORCES_KNAME: Final = "mapped_forces"
PROJCOORDS_KNAME: Final = "mapped_coords"
TMAP_KNAME: Final = "tmap"
RESIDUAL_KNAME: Final = "residual"
CONSTRAINTS_KNAME: Final = "constraints"


def project_forces(
    coords,
    forces,
    coord_map: LinearMap,
    constrained_inds: Union[Constraints, str, None] = PROJECT_FORCES_CNSTR_AUTO,
    method: Optional[Callable[..., TMap]] = None,
    **kwargs,
) -> Dict[str, Any]:
    r"""Derive an optimized force map and apply it.

    Arguments:
    ---------
    coords:
        (n_frames, n_sites, n_dim) positions, numpy or a torch tensor.
    forces:
        (n_frames, n_sites, n_dim) forces.
    coord_map:
        LinearMap fixing the configurational fg -> cg map.
    constrained_inds:
        Set of frozensets of constrained site groups. "auto" (detection of
        pairwise constraints from coordinate fluctuations) waits for the
        constraint finder, ROADMAP Queue 1 item 6, and raises.
    method:
        Map builder, e.g. ``qp_feat_linear_map``; receives
        traj/coord_map/constraints plus ``kwargs`` (``device=None`` there
        means the GPU). The JAX package's default, ``qp_linear_map``, waits
        for ROADMAP Queue 1 item 6, so the method must be given.

    Returns:
    -------
    Dict with mapped_coords, mapped_forces, tmap, residual (force_smoothness
    of the mapped forces — computed in-sample), and constraints.
    """
    if isinstance(constrained_inds, str):
        if constrained_inds != PROJECT_FORCES_CNSTR_AUTO:
            raise ValueError(f"Unknown constraint mode '{constrained_inds}'.")
        raise NotImplementedError(
            "constrained_inds='auto' needs guess_pairwise_constraints, which "
            "is not ported yet (ROADMAP Queue 1 item 6); pass the constraint "
            "groups explicitly"
        )
    if method is None:
        raise NotImplementedError(
            "the default method, qp_linear_map, is not ported yet (ROADMAP "
            "Queue 1 item 6); pass method=qp_feat_linear_map"
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


def force_smoothness(array) -> float:
    """Mean squared element — the force-map quality residual.

    Tensors reduce on their device and fetch one scalar, so scoring a
    device-resident mapped trajectory does not pull the whole array to host.
    """
    if isinstance(array, torch.Tensor):
        return float(torch.mean(torch.square(array)))
    return float(np.mean(np.asarray(array) ** 2))
