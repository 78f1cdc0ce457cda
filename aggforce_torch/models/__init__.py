"""Model registry: the force-map families this framework provides.

Counterpart of the JAX package's ``models/__init__.py``. The "models" of a
force-aggregation framework are its map families (reference README.md /
SURVEY.md §0): constraint-aware uniform aggregation, optimal static linear
maps, featurized configuration-dependent maps, and the four Gaussian
noised-map variants. This module names them uniformly so scripts and sweeps
can select a family by string; each entry is a ``method``-compatible builder
for :func:`aggforce_torch.project_forces`.
"""

from typing import Callable, Dict, List

from ..map import TMap
from ..qp import (
    constraint_aware_uni_map,
    fused_gb_linear_map,
    joptgauss_map,
    qp_feat_linear_map,
    qp_linear_map,
    stagedjforcegauss_map,
    stagedjoptgauss_map,
    stagedjslicegauss_map,
)

MAP_FAMILIES: Dict[str, Callable[..., TMap]] = {
    "basic": constraint_aware_uni_map,
    "linear": qp_linear_map,
    "featurized": qp_feat_linear_map,
    # the canonical id+gb featurization on the fused kernel path (what
    # "featurized" dispatches to; exposed directly so sweeps can name it
    # and pass GBFeatSpec instead of featurizer objects)
    "fused_featurized": fused_gb_linear_map,
    "gauss": joptgauss_map,
    "staged_gauss": stagedjoptgauss_map,
    "staged_slice_gauss": stagedjslicegauss_map,
    "staged_force_gauss": stagedjforcegauss_map,
}


def get_map_builder(name: str) -> Callable[..., TMap]:
    """Look up a map-family builder by name (see :data:`MAP_FAMILIES`)."""
    try:
        return MAP_FAMILIES[name]
    except KeyError:
        raise ValueError(
            f"Unknown map family {name!r}; available: {sorted(MAP_FAMILIES)}"
        ) from None


def available_families() -> List[str]:
    """Sorted names of all registered map families."""
    return sorted(MAP_FAMILIES)
