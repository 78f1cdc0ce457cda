"""Trajectory containers, the augmenter contract and the Gaussian augmenters."""
# ruff: noqa: F401
from .core import (
    ForcesTrajectory,
    CoordsTrajectory,
    Trajectory,
    AugmentedTrajectory,
)
from .augment import Augmenter
from .gaussian import SimpleCondNormal, TCondNormal
