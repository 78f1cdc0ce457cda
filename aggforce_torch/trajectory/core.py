"""Trajectory containers: coords/forces arrays plus augmented phase spaces.

Behavior parity targets: reference trajectory/core.py:18-221 (the three basic
containers: shape-validated, slice-only indexing, copy/astype) and :227-603
(AugmentedTrajectory: concatenated real+virtual particles with thermally
scaled log-gradient forces, refresh/pullback/from_trajectory semantics).

The containers hold numpy arrays or torch tensors. A tensor stays on its
device: copies, casts and concatenations of tensors are torch operations, so
a trajectory staged on the GPU is never pulled back to the host here. Device
work happens inside the code that consumes the arrays (maps, augmenters,
fits).
"""

from copy import deepcopy
from typing import Any, Callable, NoReturn, Optional, Tuple, TypeVar

import numpy as np
import torch

from .augment import Augmenter

A = TypeVar("A")


def _concatenate(arrays, axis: int):
    """Concatenate with torch when any argument is a tensor, else numpy."""
    if any(isinstance(a, torch.Tensor) for a in arrays):
        return torch.cat([torch.as_tensor(a) for a in arrays], dim=axis)
    return np.concatenate(arrays, axis=axis)


def _copy(x):
    """Deep copy of a numpy array or a tensor (on the tensor's device)."""
    return x.clone() if isinstance(x, torch.Tensor) else x.copy()


def _astype(x, dtype):
    """Cast a numpy array, or a tensor on its own device, to ``dtype``.

    ``dtype`` may be a numpy dtype (as the numpy-facing API passes it) or a
    torch dtype.
    """
    if isinstance(x, torch.Tensor):
        if not isinstance(dtype, torch.dtype):
            dtype = torch.from_numpy(np.empty(0, dtype=dtype)).dtype
        return x.to(dtype)
    return x.astype(dtype)


class ForcesTrajectory:
    """Frames of per-site forces, without positions."""

    def __init__(self, *, forces: np.ndarray) -> None:
        if forces.ndim != 3:
            raise ValueError("forces must have 3 dimensions.")
        self.forces = forces

    @property
    def n_sites(self) -> int:
        """Number of particles."""
        return self.forces.shape[1]

    @property
    def n_dim(self) -> int:
        """Spatial dimension (3 for MD)."""
        return self.forces.shape[2]

    def __len__(self) -> int:
        return len(self.forces)

    def __getitem__(self, index: slice) -> "ForcesTrajectory":
        if not isinstance(index, slice):
            raise ValueError("Only slices are allowed for indexing.")
        return self.__class__(forces=self.forces[index])

    def copy(self) -> "ForcesTrajectory":
        """Deep-copy the underlying array."""
        return self.__class__(forces=_copy(self.forces))

    def astype(self, dtype) -> "ForcesTrajectory":
        """Return an instance with the forces cast to ``dtype``."""
        return self.__class__(forces=_astype(self.forces, dtype))


class CoordsTrajectory:
    """Frames of per-site positions, without forces."""

    def __init__(self, *, coords: np.ndarray) -> None:
        if coords.ndim != 3:
            raise ValueError("coords must have 3 dimensions.")
        self.coords = coords

    @property
    def n_sites(self) -> int:
        """Number of particles."""
        return self.coords.shape[1]

    @property
    def n_dim(self) -> int:
        """Spatial dimension (3 for MD)."""
        return self.coords.shape[2]

    def __len__(self) -> int:
        return len(self.coords)

    def __getitem__(self, index: slice) -> "CoordsTrajectory":
        if not isinstance(index, slice):
            raise ValueError("Only slices are allowed for indexing.")
        return self.__class__(coords=self.coords[index])

    def copy(self) -> "CoordsTrajectory":
        """Deep-copy the underlying array."""
        return self.__class__(coords=_copy(self.coords))

    def astype(self, dtype) -> "CoordsTrajectory":
        """Return an instance with the coords cast to ``dtype``."""
        return self.__class__(coords=_astype(self.coords, dtype))


class Trajectory(CoordsTrajectory, ForcesTrajectory):
    """Paired coordinates and forces of equal shape (n_frames, n_sites, n_dim)."""

    def __init__(self, *, coords: np.ndarray, forces: np.ndarray) -> None:
        if coords.shape != forces.shape:
            raise ValueError("coords and forces must be of same shape.")
        if coords.ndim != 3:
            raise ValueError("coords and forces must have 3 dimensions.")
        CoordsTrajectory.__init__(self, coords=coords)
        ForcesTrajectory.__init__(self, forces=forces)

    def __getitem__(self, index: slice) -> "Trajectory":
        if not isinstance(index, slice):
            raise ValueError("Only slices are allowed for indexing.")
        return Trajectory(coords=self.coords[index], forces=self.forces[index])

    def copy(self) -> "Trajectory":
        """Deep-copy both arrays."""
        return Trajectory(coords=_copy(self.coords), forces=_copy(self.forces))

    def astype(self, dtype) -> "Trajectory":
        """Cast both arrays to ``dtype``."""
        return self.__class__(
            coords=_astype(self.coords, dtype),
            forces=_astype(self.forces, dtype),
        )


class AugmentedTrajectory(Trajectory):
    r"""Trajectory whose state space is extended by sampled virtual particles.

    Given real samples ``(x, -grad U(x))`` and an :class:`Augmenter` modeling
    g(y|x), the extended ensemble over (x, y) has density g(y|x) f(x) and
    forces

        forces_x = -grad_x U(x) + kbt * grad_x log g(y|x)
        forces_y =                kbt * grad_y log g(y|x)

    ``coords``/``forces`` hold the concatenated [real, virtual] arrays from a
    single augmenter draw; ``refresh`` redraws them; ``real_coords`` /
    ``real_forces`` expose the untouched inputs.
    """

    def __init__(
        self,
        *,
        coords: np.ndarray,
        forces: np.ndarray,
        augmenter: Augmenter,
        kbt: float,
        override_first_augment: Optional[Tuple[np.ndarray, np.ndarray]] = None,
    ) -> None:
        """Initialize from *real* coords/forces plus an augmenter.

        ``override_first_augment``, when given, supplies the already-augmented
        (coords, forces) pair instead of drawing fresh noise — used internally
        by slicing/copy so those operations stay deterministic.
        """
        self.augmenter = augmenter
        self.kbt = kbt
        self._real_forces = forces
        self._real_n_sites = coords.shape[1]
        if override_first_augment is None:
            ext_coords, ext_forces = self._augment(coords, forces)
        else:
            ext_coords, ext_forces = override_first_augment
        super().__init__(coords=ext_coords, forces=ext_forces)

    def _augment(
        self, coords: np.ndarray, forces: np.ndarray
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Draw virtual particles and build extended coords/forces arrays.

        Type-preserving: tensor inputs concatenate on their device, so the
        noised-map pipelines never round-trip trajectory-sized arrays through
        the host (the reference concatenates with numpy,
        trajectory/core.py:353-390). Augmenters exposing ``fused_augment``
        emit the extended arrays in one call.
        """
        fused = getattr(self.augmenter, "fused_augment", None)
        if fused is not None:
            result = fused(coords, forces, self.kbt)
            if result is not None:
                return result
        aug_coords = self.augmenter.sample(coords)
        real_corr, aug_lgrad = self.augmenter.log_gradient(coords, aug_coords)
        full_coords = _concatenate([coords, aug_coords], axis=1)
        full_forces = _concatenate(
            [forces + self.kbt * real_corr, self.kbt * aug_lgrad], axis=1
        )
        return full_coords, full_forces

    @property
    def real_coords(self) -> np.ndarray:
        """Positions of the physical particles (leading site block)."""
        return self.coords[:, : self._real_n_sites, :]

    @real_coords.setter
    def real_coords(self, value: Any) -> NoReturn:  # noqa: ARG002
        raise ValueError("real_coords cannot be reassigned.")

    @property
    def real_forces(self) -> np.ndarray:
        """Forces of the physical particles *before* augmentation correction."""
        return self._real_forces

    @real_forces.setter
    def real_forces(self, value: Any) -> NoReturn:  # noqa: ARG002
        raise ValueError("real_forces cannot be reassigned.")

    @property
    def n_real_sites(self) -> int:
        """Number of physical particles."""
        return self._real_n_sites

    @property
    def n_aug_sites(self) -> int:
        """Number of virtual particles."""
        return self.coords.shape[1] - self._real_n_sites

    @property
    def real_slice(self) -> slice:
        """Site-axis slice selecting physical particles."""
        return slice(0, self.n_real_sites)

    @property
    def aug_slice(self) -> slice:
        """Site-axis slice selecting virtual particles."""
        return slice(self.n_real_sites, self.n_real_sites + self.n_aug_sites)

    def refresh(self) -> None:
        """Redraw the virtual particles (new noise realization)."""
        self.coords, self.forces = self._augment(
            coords=self.real_coords, forces=self.real_forces
        )

    def __getitem__(self, index: slice) -> "AugmentedTrajectory":
        if not isinstance(index, slice):
            raise ValueError("Only slices are allowed for indexing.")
        return AugmentedTrajectory(
            coords=self.real_coords[index],
            forces=self.real_forces[index],
            augmenter=self.augmenter,
            kbt=self.kbt,
            override_first_augment=(self.coords[index], self.forces[index]),
        )

    def copy(self) -> "AugmentedTrajectory":
        """Copy arrays and augmenter without redrawing noise."""
        return self.__class__(
            coords=_copy(self.real_coords),
            forces=_copy(self.real_forces),
            augmenter=deepcopy(self.augmenter),
            kbt=self.kbt,
            override_first_augment=(_copy(self.coords), _copy(self.forces)),
        )

    def astype(self, dtype) -> "AugmentedTrajectory":
        """Cast arrays (and the augmenter) to a dtype without redrawing."""
        return self.__class__(
            coords=_astype(self.real_coords, dtype),
            forces=_astype(self.real_forces, dtype),
            augmenter=self.augmenter.astype(dtype),
            kbt=self.kbt,
            override_first_augment=(
                _astype(self.coords, dtype),
                _astype(self.forces, dtype),
            ),
        )

    def pullback(
        self,
        C: Callable[["AugmentedTrajectory"], A],
        array: bool = False,
    ) -> Callable:
        """Lift a callable on AugmentedTrajectory to one on raw inputs.

        With ``array=False`` the result maps a :class:`Trajectory`; with
        ``array=True`` it maps ``(coords, forces)`` arrays. Either way an
        intermediate AugmentedTrajectory is constructed with this instance's
        augmenter and kbt (fresh noise per call).
        """
        if array:

            def array_wrapped(coords: np.ndarray, forces: np.ndarray) -> A:
                return C(
                    self.__class__(
                        coords=coords,
                        forces=forces,
                        augmenter=self.augmenter,
                        kbt=self.kbt,
                    )
                )

            return array_wrapped

        def traj_wrapped(t: Trajectory) -> A:
            return C(
                self.__class__(
                    coords=t.coords,
                    forces=t.forces,
                    augmenter=self.augmenter,
                    kbt=self.kbt,
                )
            )

        return traj_wrapped

    @classmethod
    def from_trajectory(
        cls, t: Trajectory, kbt: float, augmenter: Augmenter
    ) -> "AugmentedTrajectory":
        """Build from an existing Trajectory (arrays shared, not copied)."""
        return cls(coords=t.coords, forces=t.forces, augmenter=augmenter, kbt=kbt)
