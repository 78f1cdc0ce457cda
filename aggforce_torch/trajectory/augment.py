"""Abstract contract for phase-space augmenters.

An Augmenter models a conditional density g(y|x): it can draw y ~ g(.|x) and
evaluate grad_{x,y} log g(y|x). AugmentedTrajectory uses these to extend a
physical ensemble with virtual particles whose "forces" are thermally scaled
log-gradients.

Behavior parity target: reference trajectory/augment.py:13-111.
"""

from abc import ABC, abstractmethod
from typing import Tuple, TypeVar

import numpy as np

_T = TypeVar("_T", bound="Augmenter")


class Augmenter(ABC):
    """Samples augmenting coordinates and evaluates conditional log-gradients."""

    @abstractmethod
    def __init__(self) -> None:
        """Configure the conditional density."""

    @abstractmethod
    def sample(self, source: np.ndarray) -> np.ndarray:
        """Draw y ~ g(.|x) for each frame of ``source``.

        ``source`` is (n_frames, n_sites, n_dim); the result is
        (n_frames, n_generated_sites, n_dim) with a frame count matching the
        input. The generated site count must be constant across calls.
        """

    @abstractmethod
    def log_gradient(
        self, source: np.ndarray, generated: np.ndarray
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Return (grad_x log g, grad_y log g) evaluated at (source, generated)."""

    @abstractmethod
    def astype(self: _T, *args, **kwargs) -> _T:
        """Return an instance producing output of the given numpy dtype."""
