"""Torch-backed linear maps (type-preserving).

Counterpart of the JAX package's ``map/jaxlinear.py`` (``JLinearMap``).
Behavior parity targets: reference map/jaxlinearmap.py:14-208 (dual-fill NaN
evaluation, numpy-in/numpy-out and tensor-in/tensor-out type preservation,
bypass_nan_check escape hatch).
"""

from typing import Tuple, Union

import numpy as np
import torch

from ..ops.torchcore import trjdot
from ..utils.device import DeviceLike, resolve_device
from ..utils.prof import span
from .core import LinearMap

_NAN_MESSAGE = (
    "NaN handling is on and multiplication tried to use a NaN "
    "value. Check the input array and standard_matrix."
)


def _nan_sites(points: torch.Tensor) -> torch.Tensor:
    """(n_sites,) bool: the sites that hold a NaN in any frame or dimension.

    One read of the frames and no full-size temporary: a max over the frames
    propagates NaN, and +/-inf is not NaN.
    """
    if points.shape[0] == 0:
        return torch.zeros(points.shape[1], dtype=torch.bool, device=points.device)
    return torch.isnan(torch.amax(points, dim=0)).any(dim=-1)


def _checked_trjdot(
    factor: torch.Tensor, points: torch.Tensor, nan_handling: bool
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Map with NaN->0 fill plus an exact participation-masked NaN verdict.

    Semantics match the reference's dual-fill protocol (a NaN is an error
    iff it touches a nonzero map weight; map/jaxlinearmap.py:14-39) but the
    verdict is computed directly — ``any(isnan(points) & participating)`` —
    instead of comparing two differently-filled products, whose reduction
    order noise would flag phantom NaNs at large contraction sizes. Only
    NaN is filled: +/-inf propagates as in the numpy LinearMap path.
    """
    if nan_handling:
        result = trjdot(points, factor, fill_nan=True)
        participating = torch.any(factor != 0.0, dim=0)  # (n_fg,)
        bad = torch.any(_nan_sites(points) & participating)
        return result, bad
    return trjdot(points, factor), torch.zeros((), dtype=torch.bool)


@span("aggforce.apply")
def fused_separable_apply(coord_map, force_map, coords, forces):
    """SeperableTMap application for two TLinearMaps with one verdict fetch.

    Returns (mapped_coords, mapped_forces) with exactly the raise/type
    semantics of applying each map individually, or None when either map
    is not a TLinearMap (callers fall back to the piecewise path).
    """
    if not isinstance(coord_map, TLinearMap) or not isinstance(
        force_map, TLinearMap
    ):
        return None
    mc, bad_c = coord_map._apply(coords)
    mf, bad_f = force_map._apply(forces)
    raise_c = coord_map.handle_nans and not coord_map.bypass_nan_check
    raise_f = force_map.handle_nans and not force_map.bypass_nan_check
    if raise_c or raise_f:
        verdict = torch.stack(
            [bad_c.to(bad_f.device) & raise_c, bad_f & raise_f]
        )
        if bool(verdict.any()):  # one host sync for both maps
            raise ValueError(_NAN_MESSAGE)
    return mc, mf


class TLinearMap(LinearMap):
    """LinearMap whose application runs as torch code on a device.

    Calls preserve the input array library: numpy in -> numpy out (computed
    on the map's device), tensor in -> tensor out (computed on the tensor's
    device). With ``bypass_nan_check=True`` the host-synchronizing NaN
    verdict is skipped.
    """

    def __init__(
        self,
        *args,
        bypass_nan_check: bool = False,
        device: DeviceLike = None,
        **kwargs,
    ) -> None:
        """Initialize; extra args forwarded to LinearMap.

        ``device`` (default: the GPU) is where numpy inputs are mapped.
        """
        super().__init__(*args, **kwargs)
        self.bypass_nan_check = bypass_nan_check
        self.device = resolve_device(device)
        self._matrices = {}

    def torch_standard_matrix(
        self, device: DeviceLike = None, dtype: torch.dtype = torch.float32
    ) -> torch.Tensor:
        """standard_matrix as a contiguous tensor (memoized per device and
        dtype). Contiguous whatever the numpy layout (a fitted map's matrix
        may be a transposed view): cuBLAS picks its kernel, and so its
        rounding, by the operand's layout, and equal maps must map alike."""
        dev = self.device if device is None else torch.device(device)
        key = (str(dev), dtype)
        if key not in self._matrices:
            self._matrices[key] = torch.as_tensor(
                np.asarray(self.standard_matrix), dtype=dtype, device=dev
            ).contiguous()
        return self._matrices[key]

    def _apply(self, points) -> Tuple[Union[np.ndarray, torch.Tensor], torch.Tensor]:
        """(mapped points in the input's library, device NaN verdict)."""
        numpy_input = not isinstance(points, torch.Tensor)
        if numpy_input:
            # float32 on the device, as the JAX twin computes numpy inputs
            points = torch.as_tensor(
                np.asarray(points), dtype=torch.float32, device=self.device
            )
        factor = self.torch_standard_matrix(points.device, points.dtype)
        result, bad = _checked_trjdot(factor, points, bool(self.handle_nans))
        return (result.cpu().numpy() if numpy_input else result), bad

    @span("aggforce.apply")
    def __call__(self, points):
        """Apply the map; input library and dtype preserved."""
        result, bad = self._apply(points)
        if self.handle_nans and not self.bypass_nan_check and bool(bad):
            raise ValueError(_NAN_MESSAGE)
        return result

    # flat_call is inherited: LinearMap.flat_call dispatches through
    # self(...), so the type-preserving behavior carries over.

    def _like(self, matrix: np.ndarray) -> "TLinearMap":
        return TLinearMap(
            mapping=matrix,
            bypass_nan_check=self.bypass_nan_check,
            handle_nans=self.handle_nans,
            nan_check_threshold=self.nan_check_threshold,
            device=self.device,
        )

    @property
    def T(self) -> "TLinearMap":
        """Map defined by the transposed standard matrix."""
        return self._like(self.standard_matrix.T)

    def __matmul__(self, lm: LinearMap, /) -> "TLinearMap":
        """Compose standard matrices."""
        return self._like(self.standard_matrix @ lm.standard_matrix)

    def __rmul__(self, c: float, /) -> "TLinearMap":
        """Scale the standard matrix."""
        return self._like(c * self.standard_matrix)

    def __add__(self, lm: LinearMap, /) -> "TLinearMap":
        """Add standard matrices."""
        return self._like(self.standard_matrix + lm.standard_matrix)

    def astype(self, *args, **kwargs) -> "TLinearMap":
        """Return an instance whose matrix is cast via numpy astype."""
        return self._like(self.standard_matrix.astype(*args, **kwargs))

    @classmethod
    def from_linearmap(
        cls,
        lm: LinearMap,
        /,
        bypass_nan_check: bool = False,
        device: DeviceLike = None,
    ) -> "TLinearMap":
        """Wrap an existing LinearMap."""
        return cls(
            mapping=lm.standard_matrix,
            bypass_nan_check=bypass_nan_check,
            handle_nans=lm.handle_nans,
            device=device,
        )

    def to_linearmap(self) -> LinearMap:
        """Drop back to the numpy LinearMap."""
        return LinearMap(mapping=self.standard_matrix, handle_nans=self.handle_nans)
