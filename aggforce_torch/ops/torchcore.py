"""Torch implementations of the core trajectory-array kernels.

Device twins of :mod:`aggforce_torch.ops.core` and counterparts of the JAX
package's ``ops/jaxcore.py``. Float32 products run in full float32 on the
card: TF32 stays off (``torch.backends.cuda.matmul.allow_tf32`` is False by
default), which is what the JAX code's ``precision="highest"`` asks for.

Behavior parity targets: reference jaxutil.py:11-59 (trjdot),
jaxutil.py:105-183 (distances with ``square`` option).
"""

from typing import Callable, Union

import torch


def trjdot(points: torch.Tensor, factor: torch.Tensor) -> torch.Tensor:
    """Map (n_frames, n_sites, n_dim) points with a (n_out, n_sites) matrix.

    A rank-3 ``factor`` of shape (n_frames, n_out, n_sites) applies a distinct
    matrix per frame (one batched GEMM).
    """
    if factor.ndim == 2:
        return torch.matmul(factor[None, :, :], points)
    if factor.ndim == 3:
        return torch.matmul(factor, points)
    raise ValueError(f"factor must be rank 2 or 3, got shape {tuple(factor.shape)}.")


def distances(
    xyz: torch.Tensor,
    cross_xyz: Union[torch.Tensor, None] = None,
    return_matrix: bool = True,
    return_displacements: bool = False,
    square: bool = False,
) -> torch.Tensor:
    """Per-frame pairwise distances.

    Same layout conventions as the numpy twin; ``square=True`` returns squared
    distances.
    """
    if cross_xyz is not None and not return_matrix:
        raise ValueError("Cross distances require return_matrix=True.")
    if return_displacements and not return_matrix:
        raise ValueError("Displacements require return_matrix=True.")
    other = xyz if cross_xyz is None else cross_xyz
    disp = xyz[:, None, :, :] - other[:, :, None, :]
    if return_displacements:
        return disp
    sq = torch.sum(disp * disp, dim=-1)
    dist = sq if square else torch.sqrt(sq)
    if return_matrix:
        return dist
    n = dist.shape[-1]
    iu, ju = torch.triu_indices(n, n, offset=1, device=dist.device)
    return dist[:, iu, ju]


def qp_form(target: torch.Tensor) -> torch.Tensor:
    """Reshape (n_frames, n_sites, n_dim) -> (n_frames*n_dim, n_sites)."""
    swapped = torch.swapaxes(target, 1, 2)
    return swapped.reshape(swapped.shape[0] * swapped.shape[1], -1)


def abatch(
    func: Callable[..., torch.Tensor],
    arr: torch.Tensor,
    chunk_size: Union[int, None],
    *args,
    **kwargs,
) -> torch.Tensor:
    """Apply ``func`` over leading-axis chunks of a tensor and re-stack.

    Chunks follow ``numpy.array_split`` (as the JAX twin's
    ``jnp.array_split``), so both packages cut the frames alike.
    """
    if chunk_size is None or chunk_size >= arr.shape[0]:
        return func(arr, *args, **kwargs)
    n_chunks = -(-len(arr) // chunk_size)
    pieces = torch.tensor_split(arr, n_chunks)
    return torch.cat([func(p, *args, **kwargs) for p in pieces], dim=0)
