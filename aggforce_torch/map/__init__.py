"""Map objects: linear site maps, co-local affine maps, trajectory maps."""
# ruff: noqa: F401
from .core import LinearMap, CLAMap
from .torchlinear import TLinearMap
from .tmap import (
    TMap,
    SeperableTMap,
    CLAFTMap,
    AugmentedTMap,
    ComposedTMap,
    NullForcesTMap,
    RATMap,
)
from .tools import lmap_augvariables, smear_map
