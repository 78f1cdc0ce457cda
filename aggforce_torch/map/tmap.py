"""Trajectory maps: joint coordinate+force transforms on Trajectory objects.

Behavior parity targets: reference map/tmap.py:33-437 — the TMap ABC plus the
concrete family: SeperableTMap (independent coord/force maps), CLAFTMap
(linear coords + configuration-dependent forces), AugmentedTMap
(augment-then-map), ComposedTMap (right-to-left composition, indexable),
NullForcesTMap (fill forces for coords-only inputs), and RATMap (map the real
block of an AugmentedTrajectory, preserving the virtual block).
"""

from abc import ABC, abstractmethod
from typing import Any, Callable, Final, Iterable, Optional, Tuple, TypeVar
from warnings import warn

import numpy as np

from ..trajectory import (
    AugmentedTrajectory,
    Augmenter,
    CoordsTrajectory,
    ForcesTrajectory,
    Trajectory,
)
from ..trajectory.core import _concatenate
from .core import CLAMap

ArrayTransform = Callable[[np.ndarray], np.ndarray]

_T_TMap = TypeVar("_T_TMap", bound="TMap")


class TMap(ABC):
    """Maps Trajectory instances to Trajectory instances."""

    @abstractmethod
    def __init__(self) -> None:
        """Initialize."""

    @abstractmethod
    def __call__(self, t: Trajectory) -> Trajectory:
        """Map a Trajectory to a new instance."""

    def map_arrays(
        self, coords: np.ndarray, forces: np.ndarray
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Map raw (coords, forces) arrays through the trajectory map."""
        derived = self(Trajectory(coords=coords, forces=forces))
        return derived.coords, derived.forces

    @abstractmethod
    def astype(self: _T_TMap, *args, **kwargs) -> _T_TMap:
        """Return an instance operating at the given numpy precision."""


class SeperableTMap(TMap):
    """Independent coordinate and force maps applied side by side."""

    def __init__(
        self,
        coord_map: ArrayTransform,
        force_map: ArrayTransform,
    ) -> None:
        """Store the two array transforms."""
        self.coord_map = coord_map
        self.force_map = force_map

    def __call__(self, t: Trajectory) -> Trajectory:
        """Map coords and forces independently.

        Two TLinearMap submaps share one NaN-verdict fetch (each individual
        application would wait for the device on its own verdict).
        """
        from .torchlinear import fused_separable_apply

        fused = fused_separable_apply(
            self.coord_map, self.force_map, t.coords, t.forces
        )
        if fused is not None:
            return Trajectory(coords=fused[0], forces=fused[1])
        return Trajectory(
            coords=self.coord_map(t.coords), forces=self.force_map(t.forces)
        )

    def astype(self, *args, **kwargs) -> "SeperableTMap":
        """Cast both submaps (requires each to support astype)."""
        try:
            return self.__class__(
                coord_map=self.coord_map.astype(*args, **kwargs),  # type: ignore[attr-defined]
                force_map=self.force_map.astype(*args, **kwargs),  # type: ignore[attr-defined]
            )
        except AttributeError as e:
            raise TypeError(
                "Underlying coord_map and/or force_map do not support astype."
            ) from e


class CLAFTMap(TMap):
    """Linear coordinate map + configuration-dependent (CLAMap) force map."""

    def __init__(self, coord_map: ArrayTransform, force_map: CLAMap) -> None:
        """coord_map maps coords alone; force_map maps forces with coords as copoints."""
        self.coord_map = coord_map
        self.force_map = force_map

    def __call__(self, t: Trajectory) -> Trajectory:
        """Map a Trajectory (coords feed the force map as copoints)."""
        return Trajectory(
            coords=self.coord_map(t.coords),
            forces=self.force_map(points=t.forces, copoints=t.coords),
        )

    def astype(self, *args, **kwargs) -> "CLAFTMap":
        """Cast both submaps (requires each to support astype)."""
        try:
            return self.__class__(
                coord_map=self.coord_map.astype(*args, **kwargs),  # type: ignore[attr-defined]
                force_map=self.force_map.astype(*args, **kwargs),  # type: ignore[attr-defined]
            )
        except AttributeError as e:
            raise TypeError(
                "Underlying coord_map and/or force_map do not support astype."
            ) from e


class AugmentedTMap(TMap):
    """Augment the input trajectory, then apply a map to the extended system."""

    def __init__(
        self,
        aug_tmap: TMap,
        augmenter: Augmenter,
        kbt: float,
    ) -> None:
        """Store the map over augmented trajectories plus augmentation params."""
        self.tmap: Final = aug_tmap
        self.augmenter: Final = augmenter
        self.kbt: Final = kbt

    def __call__(self, t: Trajectory) -> Trajectory:
        """Augment (fresh noise draw) then map.

        When the augmenter and submaps support it (TCondNormal with linear
        pre/post maps, SeperableTMap of LinearMaps, tensor input), the
        whole application — noising, coordinate map, force map, NaN
        verdicts — is enqueued on the device with one host sync
        (TCondNormal.fused_map_apply); otherwise the piecewise path runs.
        """
        fused = getattr(self.augmenter, "fused_map_apply", None)
        if fused is not None and isinstance(self.tmap, SeperableTMap):
            out = fused(
                t.coords, t.forces, self.kbt,
                self.tmap.coord_map, self.tmap.force_map,
            )
            if out is not None:
                return Trajectory(coords=out[0], forces=out[1])
        augmented = AugmentedTrajectory.from_trajectory(
            t=t, kbt=self.kbt, augmenter=self.augmenter
        )
        return self.tmap(augmented)

    def astype(self, *args, **kwargs) -> "AugmentedTMap":
        """Cast the inner map and augmenter."""
        return self.__class__(
            aug_tmap=self.tmap.astype(*args, **kwargs),
            augmenter=self.augmenter.astype(*args, **kwargs),
            kbt=self.kbt,
        )


class ComposedTMap(TMap):
    """Apply several TMaps in sequence (rightmost first, like composition)."""

    def __init__(self, submaps: Iterable[TMap]) -> None:
        """Store submaps; integer indexing retrieves them."""
        self.submaps: Final = list(submaps)

    def __call__(self, t: Trajectory) -> Trajectory:
        """Apply submaps right to left."""
        result = t
        for mapping in reversed(self.submaps):
            result = mapping(result)
        return result

    def __getitem__(self, idx: int, /) -> TMap:
        """Return submap ``idx``."""
        return self.submaps[idx]

    def map_arrays(
        self,
        coords: np.ndarray,
        forces: Optional[np.ndarray] = None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Map arrays; ``forces`` may be None when the innermost submap
        tolerates coordinate-only input (e.g. NullForcesTMap)."""
        if forces is None:
            derived = self(CoordsTrajectory(coords=coords))
        else:
            derived = self(Trajectory(coords=coords, forces=forces))
        return derived.coords, derived.forces

    def astype(self, *args, **kwargs) -> "ComposedTMap":
        """Cast every submap."""
        return self.__class__(
            submaps=[m.astype(*args, **kwargs) for m in self.submaps]
        )


class NullForcesTMap(TMap):
    """Replace (or create) the force block with a fill value.

    Lets coordinate-only data flow through TMap pipelines that formally
    require forces.
    """

    def __init__(
        self, warn_input_forces: bool = True, fill_value: Any = np.nan
    ) -> None:
        """``warn_input_forces`` warns when real forces get discarded."""
        self.warn_input_forces = warn_input_forces
        self.fill_value = fill_value

    def __call__(self, t: CoordsTrajectory) -> Trajectory:
        """Return a Trajectory with filled forces."""
        if isinstance(t, ForcesTrajectory) and self.warn_input_forces:
            warn("Discarding forces on input trajectory.", stacklevel=0)
        return Trajectory(coords=t.coords, forces=self.fill_value * t.coords)

    def map_arrays(
        self,
        coords: np.ndarray,
        forces: Optional[np.ndarray] = None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Map arrays; unlike other TMaps, ``forces`` may be omitted."""
        if forces is None:
            t: CoordsTrajectory = CoordsTrajectory(coords=coords)
        else:
            t = Trajectory(coords=coords, forces=forces)
        derived = self(t)
        return derived.coords, derived.forces

    def astype(self, *args, **kwargs) -> "NullForcesTMap":  # noqa: ARG002
        """Precision-free; returns an equivalent instance."""
        return self.__class__(
            warn_input_forces=self.warn_input_forces, fill_value=self.fill_value
        )


class RATMap:
    """Apply a TMap to the real block of an AugmentedTrajectory.

    The virtual (augmenting) particles pass through untouched, so a
    pre-derived map over physical sites can partially coarse-grain an
    augmented system.
    """

    def __init__(self, tmap: TMap) -> None:
        """Store the map for the real particle block."""
        self.tmap = tmap

    def __call__(self, t: AugmentedTrajectory) -> Trajectory:
        """Map real block, concatenate preserved virtual block.

        Tensors concatenate on their device so staged noised-map pipelines
        stay resident.
        """
        coords, forces = self.tmap.map_arrays(
            t.coords[:, t.real_slice, :], t.forces[:, t.real_slice, :]
        )
        return Trajectory(
            coords=_concatenate([coords, t.coords[:, t.aug_slice, :]], axis=1),
            forces=_concatenate([forces, t.forces[:, t.aug_slice, :]], axis=1),
        )
