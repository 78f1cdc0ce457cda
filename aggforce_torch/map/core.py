"""Linear and co-local affine site maps.

Behavior parity targets: reference map/core.py:46-317 (LinearMap: standard
matrix semantics, list-of-lists construction with uniform weights, NaN
handling protocol, flat_call, T/@/rmul/+/astype algebra) and :320-431 (CLAMap:
configuration-dependent affine map with zero-probe shape inference and tags).

The NaN protocol doubles as a numerical sanitizer: inputs containing NaN are
mapped twice with the NaNs replaced by two different fill values; if the
results differ, a zero-weight assumption was violated and an error is raised.
"""

from typing import Callable, Dict, Final, List, Literal, Optional, Union

import numpy as np

from ..ops.core import trjdot


def _has_nans(x: np.ndarray) -> bool:
    """Fast NaN detection via a self-dot (NaN propagates to the scalar)."""
    flat = np.ravel(x, order="K")
    return bool(np.isnan(np.dot(flat, flat)))


class _Taggable:
    """Mixin carrying a free-form string-keyed tags dict for optimizer logs."""

    def __init__(self, tags: Union[None, Dict[str, str]]) -> None:
        self.tags = {} if tags is None else tags


class LinearMap:
    r"""A static linear map between fine-grained and coarse-grained sites.

    The canonical representation is ``standard_matrix``: an
    (n_cg_sites, n_fg_sites) matrix of per-site contribution weights.
    Instances are callable on (n_frames, n_sites, n_dim) arrays.
    """

    n_dim: Final = 3

    def __init__(
        self,
        mapping: Union[List[List[int]], np.ndarray],
        n_fg_sites: Optional[int] = None,
        handle_nans: Union[bool, Literal["safe"]] = True,
        nan_check_threshold: float = 1e-6,
    ) -> None:
        r"""Initialize from an explicit matrix or index lists.

        ``mapping`` as a 2-D array is taken as the standard matrix directly
        (n_fg_sites must then be omitted). As a list of index lists, entry i
        lists the fg sites contributing (with uniform weight) to cg site i,
        and n_fg_sites must be supplied.

        ``handle_nans`` enables the NaN-consistency protocol on calls: NaN
        entries may only interact with zero weights; otherwise a ValueError is
        raised. "safe" additionally avoids temporary in-place edits of input.
        """
        if isinstance(mapping, np.ndarray) and mapping.ndim == 2:
            if n_fg_sites is not None:
                raise ValueError(
                    "Cannot specify n_fg_sites when mapping is an array; it is "
                    "inferred."
                )
            self._standard_matrix = mapping
        elif hasattr(mapping, "__iter__"):
            if n_fg_sites is None:
                raise ValueError(
                    "n_fg_sites is required when mapping is given as index lists."
                )
            groups = list(mapping)
            mat = np.zeros((len(groups), n_fg_sites))
            for row, contents in enumerate(groups):
                mat[row, list(contents)] = 1.0 / len(contents)
            self._standard_matrix = mat
        else:
            raise ValueError(f"Cannot understand mapping {mapping!r}.")

        self.handle_nans = handle_nans
        if self.handle_nans and not np.all(np.isfinite(self._standard_matrix)):
            raise ValueError(
                "NaN checking requires a finite standard_matrix."
            )
        self.nan_check_threshold = nan_check_threshold

    @property
    def standard_matrix(self) -> np.ndarray:
        """The (n_cg_sites, n_fg_sites) weight matrix."""
        return self._standard_matrix

    @property
    def n_cg_sites(self) -> int:
        """Output (coarse-grained) site count."""
        return self._standard_matrix.shape[0]

    @property
    def n_fg_sites(self) -> int:
        """Input (fine-grained) site count."""
        return self._standard_matrix.shape[1]

    @property
    def participating_fg(self) -> List[List[int]]:
        """For each cg site, the fg indices with positive weight."""
        table: List[List[int]] = [[] for _ in range(self.n_cg_sites)]
        for cg_ind, fg_ind in zip(*np.nonzero(self._standard_matrix > 0)):
            table[cg_ind].append(int(fg_ind))
        return table

    def close_to_identity(self, threshold: float = 1e-8) -> bool:
        """True if square and within Frobenius ``threshold`` of the identity."""
        m = self._standard_matrix
        if m.shape[0] != m.shape[1]:
            return False
        return float(np.sqrt(((np.eye(m.shape[0], dtype=m.dtype) - m) ** 2).sum())) <= threshold

    def __call__(self, points: np.ndarray) -> np.ndarray:
        """Apply the map along the site axis of (n_frames, n_sites, n_dim)."""
        if self.handle_nans and _has_nans(points):
            mask = np.isnan(points)
            work = points.copy() if self.handle_nans == "safe" else points
            work[mask] = 0.0
            zero_fill = trjdot(work, self._standard_matrix)
            work[mask] = -1.0
            probe_fill = trjdot(work, self._standard_matrix)
            work[mask] = np.nan
            if not np.allclose(
                zero_fill, probe_fill, atol=self.nan_check_threshold
            ):
                raise ValueError(
                    "NaN handling is on and results depend on NaN positions in "
                    "the input array. Check input and standard_matrix."
                )
            return zero_fill
        return trjdot(points, self._standard_matrix)

    def flat_call(self, flattened: np.ndarray) -> np.ndarray:
        """Apply to (n_frames, n_sites*n_dim) arrays; returns the flat result."""
        shape = flattened.shape
        if len(shape) != 2:
            raise ValueError(f"Expected rank-2 array; got shape {shape}.")
        if shape[1] % self.n_dim != 0:
            raise ValueError(
                f"Array of shape {shape} is incompatible with n_dim {self.n_dim}."
            )
        reshaped = flattened.reshape(shape[0], shape[1] // self.n_dim, self.n_dim)
        out = self(reshaped)
        return out.reshape(out.shape[0], out.shape[1] * out.shape[2])

    def _like(self, matrix: np.ndarray) -> "LinearMap":
        return LinearMap(
            mapping=matrix,
            handle_nans=self.handle_nans,
            nan_check_threshold=self.nan_check_threshold,
        )

    @property
    def T(self) -> "LinearMap":
        """Map defined by the transposed standard matrix."""
        return self._like(self._standard_matrix.T)

    def __matmul__(self, lm: "LinearMap", /) -> "LinearMap":
        """Compose standard matrices."""
        return self._like(self._standard_matrix @ lm.standard_matrix)

    def __rmul__(self, c: float, /) -> "LinearMap":
        """Scale the standard matrix."""
        return self._like(c * self._standard_matrix)

    def __add__(self, lm: "LinearMap", /) -> "LinearMap":
        """Add standard matrices."""
        return self._like(self._standard_matrix + lm.standard_matrix)

    def astype(self, *args, **kwargs) -> "LinearMap":
        """Return an instance whose matrix is cast via numpy astype."""
        return self.__class__(
            mapping=self._standard_matrix.astype(*args, **kwargs),
            handle_nans=self.handle_nans,
            nan_check_threshold=self.nan_check_threshold,
        )


class CLAMap(_Taggable):
    r"""Co-local affine map: x -> A(y) x + b(y).

    ``scale`` maps copoints (n_frames, n_fg, n_dim) to per-frame matrices
    (n_frames, n_cg, n_fg); ``trans`` maps copoints to offsets
    (n_frames, n_cg, n_dim). Configuration-dependent force maps are expressed
    this way (forces as points, coordinates as copoints).
    """

    n_dim: Final = 3

    def __init__(
        self,
        scale: Callable,
        trans: Callable,
        n_fg_sites: int,
        n_cg_sites: Optional[int] = None,
        zeroes_check: bool = True,
        tags: Optional[Dict[str, str]] = None,
    ) -> None:
        """Initialize from scale/trans callables.

        ``zeroes_check`` probes both callables with a zero frame to validate
        shapes and, if needed, infer ``n_cg_sites``.
        """
        super().__init__(tags=tags)
        if zeroes_check:
            probe = np.zeros((1, n_fg_sites, self.n_dim))
            mapped = trjdot(probe, scale(probe)) + trans(probe)
            if n_cg_sites is None:
                n_cg_sites = mapped.shape[1]
            elif n_cg_sites != mapped.shape[1]:
                raise ValueError("n_cg_sites did not match results from zero test")
        elif n_cg_sites is None:
            raise ValueError("If n_cg_sites is not set, zeroes_check must be truthy.")
        self._n_cg_sites: Final = n_cg_sites
        self._n_fg_sites: Final = n_fg_sites
        self.scale: Final = scale
        self.trans: Final = trans

    @property
    def n_cg_sites(self) -> int:
        """Output site count."""
        return self._n_cg_sites

    @property
    def n_fg_sites(self) -> int:
        """Input site count."""
        return self._n_fg_sites

    def __call__(
        self, points: np.ndarray, copoints: Optional[np.ndarray]
    ) -> np.ndarray:
        """Apply the configuration-dependent map."""
        return trjdot(points, self.scale(copoints)) + self.trans(copoints)
