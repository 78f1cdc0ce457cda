"""Specialized map constructors.

Behavior parity targets: reference map/tools.py:13-33 (``lmap_augvariables``
slice map isolating augmented sites) and :63-104 (``smear_map`` replacing
constrained groups with their mean, as a square matrix).
"""

from itertools import combinations
from typing import Iterable, Union

import numpy as np

from ..trajectory import AugmentedTrajectory
from .core import LinearMap


def lmap_augvariables(aug: AugmentedTrajectory) -> LinearMap:
    """LinearMap selecting only the augmenter-generated sites of ``aug``."""
    inds = [[x] for x in range(aug.n_real_sites, aug.n_sites)]
    return LinearMap(inds, n_fg_sites=aug.n_sites)


def smear_map(
    site_groups: Iterable[Iterable[int]],
    n_sites: int,
    return_mapping_matrix: bool = False,
) -> Union[LinearMap, np.ndarray]:
    """Square map replacing each listed group of sites with its group mean.

    Dimensionality is preserved: ungrouped sites map to themselves; each site
    in a group maps to the mean position of the group. Groups must be
    disjoint.
    """
    site_sets = [set(g) for g in site_groups]
    for a, b in combinations(site_sets, 2):
        if a & b:
            raise ValueError(
                "Site definitions in site_groups overlap; merge before passing."
            )
    matrix = np.eye(n_sites, dtype=np.float32)
    for group in site_sets:
        idx = np.array(sorted(group))
        matrix[np.ix_(idx, idx)] = 1.0 / len(group)
        # zero out the diagonal identity for grouped rows is implicit: the
        # block assignment overwrites the 1.0 entries inside the group block.
    if return_mapping_matrix:
        return matrix
    return LinearMap(mapping=matrix)
