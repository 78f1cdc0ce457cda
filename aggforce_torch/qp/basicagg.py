"""Constraint-aware uniform force aggregation.

A copy of the JAX package's ``qp/basicagg.py``. Behavior parity target: reference qp/basicagg.py:11-62 — each cg site
aggregates (weight 1.0) the forces of its contributing fg sites plus any fg
sites joined to them through constraint groups.
"""

from typing import Optional

import numpy as np
import torch

from ..constraints import Constraints, reduce_constraint_sets
from ..map import LinearMap, SeperableTMap, TLinearMap
from ..trajectory import ForcesTrajectory
from ..utils.device import DeviceLike


def constraint_aware_uni_map(
    traj: ForcesTrajectory,
    coord_map: LinearMap,
    constraints: Optional[Constraints] = None,
    device: DeviceLike = None,  # noqa: ARG001
) -> SeperableTMap:
    """Uniform-weight force map compatible with molecular constraints.

    ``traj`` only sets the kind of map returned, as for ``qp_linear_map``:
    tensor forces give maps that apply as torch code on their device
    (``TLinearMap``), numpy forces give numpy ``LinearMap`` maps. The map
    is built on the host from the coordinate map alone, so ``device`` is
    accepted for the signature ``project_forces`` passes on, and unused.
    """
    if constraints is None:
        constraints = set()
    cg_sets = [set(np.nonzero(row)[0].tolist()) for row in coord_map.standard_matrix]
    groups = reduce_constraint_sets(constraints)
    for members in cg_sets:
        for group in groups:
            if members & group:
                members |= group
    force_mat = np.zeros_like(coord_map.standard_matrix)
    for cg_index, members in enumerate(cg_sets):
        force_mat[cg_index, sorted(members)] = 1.0
    forces = getattr(traj, "forces", None)
    if isinstance(forces, torch.Tensor):
        return SeperableTMap(
            coord_map=TLinearMap.from_linearmap(coord_map, device=forces.device),
            force_map=TLinearMap(force_mat, device=forces.device),
        )
    return SeperableTMap(coord_map=coord_map, force_map=LinearMap(force_mat))
