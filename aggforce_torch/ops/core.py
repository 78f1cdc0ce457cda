"""Numpy implementations of the core trajectory-array kernels.

These are the host-side (numpy) twins of :mod:`aggforce_torch.ops.torchcore`;
the numpy versions exist so the orchestration layer (map objects applied to
numpy data, constraint finding on small inputs) has no device dependency and so
tests can cross-check device kernels against a simple reference.

Semantics parity targets (reference, for behavior only):
  - ``trjdot``    — util.py:79-125
  - ``distances`` — util.py:12-76
  - ``qp_form``   — qp/qplinear.py:91-103
  - ``abatch``    — jaxutil.py:62-102
"""

from typing import Callable, Optional, Union

import numpy as np


def trjdot(points: np.ndarray, factor: np.ndarray) -> np.ndarray:
    """Map an (n_frames, n_sites, n_dim) array with a site-mixing matrix.

    ``factor`` is either a static (n_out, n_sites) matrix shared by every frame
    or an (n_frames, n_out, n_sites) stack applying a different matrix per
    frame. Returns (n_frames, n_out, n_dim).
    """
    if factor.ndim == 2:
        # (t f d),(c f) -> t c d ; matmul form keeps BLAS on the fast path
        return np.matmul(factor[None, :, :], points)
    if factor.ndim == 3:
        return np.matmul(factor, points)
    raise ValueError(f"factor must be rank 2 or 3, got shape {factor.shape}.")


def distances(
    xyz: np.ndarray,
    cross_xyz: Optional[np.ndarray] = None,
    return_matrix: bool = True,
    return_displacements: bool = False,
) -> np.ndarray:
    """Per-frame pairwise distances (or displacements) of a trajectory.

    With ``cross_xyz`` given, result[t, i, j] is the distance between
    ``cross_xyz[t, i]`` and ``xyz[t, j]``. Without it, distances are within
    ``xyz``. ``return_matrix=False`` extracts the strict upper triangle
    (flattened); ``return_displacements=True`` returns the displacement
    vectors instead (both only in the supported combinations).
    """
    if cross_xyz is not None and not return_matrix:
        raise ValueError("Cross distances require return_matrix=True.")
    if return_displacements and not return_matrix:
        raise ValueError("Displacements require return_matrix=True.")
    other = xyz if cross_xyz is None else cross_xyz
    disp = xyz[:, None, :, :] - other[:, :, None, :]
    if return_displacements:
        return disp
    dist = np.linalg.norm(disp, axis=-1)
    if return_matrix:
        return dist
    n = dist.shape[-1]
    iu, ju = np.triu_indices(n, k=1)
    return dist[:, iu, ju]


def qp_form(target: np.ndarray) -> np.ndarray:
    """Reshape (n_frames, n_sites, n_dim) -> (n_frames*n_dim, n_sites).

    Rows are ordered (frame0,dim0), (frame0,dim1), ..., so that a single
    least-squares design matrix covers every frame and Cartesian component.
    """
    swapped = np.swapaxes(target, 1, 2)
    return swapped.reshape(swapped.shape[0] * swapped.shape[1], -1)


def abatch(
    func: Callable[..., np.ndarray],
    arr: np.ndarray,
    chunk_size: Union[int, None],
    *args,
    **kwargs,
) -> np.ndarray:
    """Apply ``func`` over leading-axis chunks of ``arr`` and re-stack.

    Bounds peak memory when ``func`` materializes large per-frame
    intermediates. ``chunk_size=None`` applies ``func`` once.
    """
    if chunk_size is None or chunk_size >= arr.shape[0]:
        return func(arr, *args, **kwargs)
    n_chunks = int(np.ceil(len(arr) / chunk_size))
    pieces = np.array_split(arr, n_chunks)
    return np.concatenate([func(p, *args, **kwargs) for p in pieces], axis=0)
