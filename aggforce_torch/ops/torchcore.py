"""Torch implementations of the core trajectory-array kernels.

Device twins of :mod:`aggforce_torch.ops.core` and counterparts of the JAX
package's ``ops/jaxcore.py``. :func:`trjdot`, which every ``TLinearMap``
applies through, runs inside ``utils.device.full_fp32()``: its float32
products stay full float32 whatever TF32 setting the process has chosen,
which is what the JAX code's ``precision="highest"`` asks for.

Behavior parity targets: reference jaxutil.py:11-59 (trjdot),
jaxutil.py:105-183 (distances with ``square`` option).
"""

import math
from typing import Callable, Union

import torch

from ..utils.device import full_fp32

# byte budget for the frames laid out for one rank-2 product; the chunk of
# frames adapts to the frame size, so the copy stays bounded at any
# trajectory length while each chunk is still one large GEMM
_LAYOUT_BYTES = 192 * 1024 * 1024


def _chunk_frames(n_frames: int, frame_bytes: int) -> int:
    """Frames per chunk: ``n_frames`` split into equal chunks under the
    budget; the last chunk holds the ragged tail."""
    n_chunks = max(1, -(-n_frames * frame_bytes // _LAYOUT_BYTES))
    return max(1, -(-n_frames // n_chunks))


@full_fp32()
def trjdot(
    points: torch.Tensor, factor: torch.Tensor, fill_nan: bool = False
) -> torch.Tensor:
    """Map (n_frames, n_sites, n_dim) points with a (n_out, n_sites) matrix.

    A rank-2 ``factor`` maps every frame with one 2-D product per chunk of
    frames: the chunk is laid out once as (frames * n_dim, n_sites), then
    ``laid @ factor.T`` runs as one GEMM, and the (frames * n_dim, n_out)
    product is copied into the contiguous (n_frames, n_out, n_dim) result.
    ``fill_nan`` (rank 2 only) sets NaN to 0 in the laid-out chunk; +/-inf
    is kept.

    A rank-3 ``factor`` of shape (n_frames, n_out, n_sites) applies a distinct
    matrix per frame (one batched GEMM).
    """
    if factor.ndim == 3 and not fill_nan:
        return torch.matmul(factor, points)
    if factor.ndim != 2:
        raise ValueError(
            "factor must be rank 2, or rank 3 without fill_nan; got shape "
            f"{tuple(factor.shape)}."
        )
    # one layout for every factor: cuBLAS picks its kernel, and so its
    # rounding, by the operands' layouts
    factor = factor.contiguous()
    n_frames, n_sites, n_dim = points.shape
    out = torch.empty(
        (n_frames, factor.shape[0], n_dim), dtype=points.dtype, device=points.device
    )
    chunk = _chunk_frames(n_frames, n_sites * n_dim * points.element_size())
    flat = torch.empty(
        min(chunk, n_frames) * n_dim * n_sites,
        dtype=points.dtype,
        device=points.device,
    )
    for start in range(0, n_frames, chunk):
        part = points[start : start + chunk].transpose(1, 2)
        t = part.shape[0]
        laid = flat[: t * n_dim * n_sites].view(t, n_dim, n_sites)
        laid.copy_(part)
        if fill_nan:
            # in place on the copy: autograd and torch.func refuse an
            # ``out=`` fill of a tracked input
            laid.nan_to_num_(nan=0.0, posinf=math.inf, neginf=-math.inf)
        prod = torch.matmul(laid.view(t * n_dim, n_sites), factor.T)
        out[start : start + t] = prod.view(t, n_dim, -1).transpose(1, 2)
    return out


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
