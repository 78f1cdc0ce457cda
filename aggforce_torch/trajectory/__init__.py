"""Trajectory containers and the augmenter contract."""
# ruff: noqa: F401
from .core import (
    ForcesTrajectory,
    CoordsTrajectory,
    Trajectory,
    AugmentedTrajectory,
)
from .augment import Augmenter
