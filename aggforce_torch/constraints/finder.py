"""Detect holonomically constrained site pairs from distance fluctuations.

Counterpart of the JAX package's ``constraints/finder.py``. Behavior parity
target: reference constraints/constfinder.py:14-57 (pairs whose per-frame
distance standard deviation falls below a threshold are declared
constrained; self pairs masked; the cross-system variant returns ordered
tuples).

The O(T N^2) fluctuation statistic runs on the device: first and second
moments of the pairwise distance fluctuations accumulate over the frames,
and only the boolean mask of constrained pairs is fetched to build the
frozenset API the rest of the package expects. On the CUDA card one
hand-written kernel (``csrc/pair_moments.cu``, :func:`pair_moments`) takes
all frames in one pass; on the CPU :func:`_distance_sd` streams frame
chunks. Distances are summed from elementwise coordinate differences in
full fp32, never through a matmul that TF32 could round (its 10-bit
mantissa puts the error on a ~1.5 nm distance above the 1e-3 threshold).
"""

import ctypes
import functools
from typing import Optional, Tuple, Union

import numpy as np
import torch

from ..utils.debug import check_finite
from ..utils.device import DeviceLike, resolve_device
from ..utils.prof import span
from .hints import Constraints

# byte budget for the live (chunk, N, N) distance block when streaming the
# moments; the frame chunk adapts to the site count so thousands-of-atoms
# systems stay well inside device memory
_BLOCK_BYTES = 192 * 1024 * 1024


def _frame_chunk(n_a: int, n_b: int) -> int:
    # the live distance block is (chunk, n_b, n_a) — in cross mode the two
    # site counts differ, and sizing from one alone can blow the budget by
    # the ratio of the other
    per_frame = n_a * n_b * 4
    return max(1, min(64, _BLOCK_BYTES // max(per_frame, 1)))


def _chunk_length(t: int, n_a: int, n_b: int) -> int:
    """Frames per chunk: ``t`` split into equal chunks under the budget; the
    last chunk holds the ragged tail."""
    n_chunks = max(1, t // _frame_chunk(n_a, n_b))
    return -(-t // n_chunks)


def _dists(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(c, n_b, n_a) distances between frames of ``b`` and ``a``.

    |a_j - b_i|^2 is summed over xyz one axis at a time, so the live block
    stays (c, n_b, n_a) with no trailing xyz axis. The differences are taken
    elementwise: there is no matmul that a TF32 setting of the process could
    round, and no cancellation (the JAX package's Gram trick,
    |a|^2 + |b|^2 - 2 a.b, loses ~|a|^2 * eps to it).
    """
    dsq = None
    for k in range(a.shape[-1]):
        diff = b[:, :, None, k] - a[:, None, :, k]
        dsq = diff * diff if dsq is None else dsq.addcmul_(diff, diff)
    return torch.sqrt(dsq)


def _distance_sd(xyz: torch.Tensor, other: torch.Tensor, chunk: int) -> torch.Tensor:
    """Std-dev over frames of every pairwise distance, (n_b, n_a).

    Streams ``chunk``-frame slices accumulating first and second moments, so
    only one (chunk, n_b, n_a) distance block is ever live. The last slice
    holds the ragged tail: every input frame participates exactly once, and
    the moments divide by the true frame count.
    """
    t = xyz.shape[0]
    # reference distances (frame 0) are subtracted before accumulating, so
    # the moments are of the small fluctuation d - d0 — this avoids the
    # catastrophic cancellation E[d^2] - E[d]^2 would suffer in float32 at
    # the 1e-3 detection threshold
    d0 = _dists(xyz[:1], other[:1])[0]
    s1 = torch.zeros_like(d0)
    s2 = torch.zeros_like(d0)
    for start in range(0, t, chunk):
        delta = _dists(xyz[start : start + chunk], other[start : start + chunk]) - d0
        s1 += delta.sum(dim=0)
        s2 += (delta * delta).sum(dim=0)
    mean = s1 / t
    var = torch.clamp_min(s2 / t - mean * mean, 0.0)
    return torch.sqrt(var)


@functools.lru_cache(maxsize=None)
def _pair_moments_lib():
    """The library built from ``csrc/pair_moments.cu``, its two C entries
    typed: ``aggforce_pair_moments_slices`` (the frame split F, which sizes
    the workspace) and ``aggforce_pair_moments`` (both launches)."""
    from ..ops import _build

    lib = _build.load("pair_moments.cu")
    lib.aggforce_pair_moments_slices.argtypes = [ctypes.c_int] * 4
    lib.aggforce_pair_moments_slices.restype = ctypes.c_int
    fn = lib.aggforce_pair_moments
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 5 + [ctypes.c_double] + [
        ctypes.c_void_p
    ] * 3
    fn.restype = ctypes.c_int
    return lib


def _check_pair_inputs(xyz, other) -> None:
    """Raise unless the coordinates meet the kernel's contract."""
    for name, x in (("xyz", xyz), ("other", other)):
        if x is None:
            continue
        if not isinstance(x, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor")
        if x.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if x.ndim != 3 or x.shape[-1] != 3 or x.shape[0] < 1 or x.shape[1] < 1:
            raise ValueError(
                f"{name} must be (T >= 1, n >= 1, 3), got {tuple(x.shape)}"
            )
    if other is not None:
        if other.shape[0] != xyz.shape[0]:
            raise ValueError(f"other has {other.shape[0]} frames, xyz {xyz.shape[0]}")
        if other.device != xyz.device:
            raise ValueError(f"other is on {other.device}, xyz on {xyz.device}")


def pair_moments(
    xyz: torch.Tensor, other: Optional[torch.Tensor] = None, threshold: float = 1e-3
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Distance sd of every site pair over all frames, and its mask.

    Returns ``(sd, hits)``, both (n_b, n_a): ``sd`` float64, of the distance
    between site i of ``other`` and site j of ``xyz`` (of ``xyz`` with itself
    when ``other`` is None), a strided view of the kernel's workspace; and
    ``hits = sd < threshold``, false on the diagonal within one system.
    The hand-written kernel
    ``csrc/pair_moments.cu``, built on first use; CUDA tensors only
    (float32, contiguous, (T, n, 3), equal frame counts), anything else
    raises. Each call adds one to ``pair_moments.launches``. Same
    arithmetic as :func:`_distance_sd` with the moments summed in fp64.
    """
    _check_pair_inputs(xyz, other)
    dev = xyz.device
    if dev.type != "cuda":
        raise ValueError(f"pair_moments runs on a CUDA card, not {dev}")
    within = other is None
    src = xyz if within else other
    t, n_a, n_b = xyz.shape[0], xyz.shape[1], src.shape[1]
    sizes = f"T={t}, n_a={n_a}, n_b={n_b}"
    lib = _pair_moments_lib()
    with torch.cuda.device(dev):
        n_slices = lib.aggforce_pair_moments_slices(t, n_a, n_b, int(within))
        if n_slices == 0:
            raise ValueError(f"aggforce_pair_moments refused {sizes}")
        if n_slices < 0:
            raise RuntimeError(
                f"aggforce_pair_moments_slices failed (cudaError {-n_slices})"
            )
        # (s1, s2) of every pair and frame slice; the finalize launch leaves
        # each pair's sd in place of slice 0's s1
        part = torch.empty((n_slices, n_b, n_a, 2), dtype=torch.float64, device=dev)
        hits = torch.empty((n_b, n_a), dtype=torch.bool, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.aggforce_pair_moments(
            xyz.data_ptr(), src.data_ptr(), t, n_a, n_b, int(within), n_slices,
            float(threshold), part.data_ptr(), hits.data_ptr(), stream,
        )
    if err < 0:
        raise ValueError(f"aggforce_pair_moments refused {sizes}, slices={n_slices}")
    if err > 0:
        raise RuntimeError(
            f"aggforce_pair_moments kernel launch failed (cudaError {err})"
        )
    pair_moments.launches += 1
    sd = part[0, :, :, 0]
    # the kernel bypasses torch's dispatch, so debug mode checks it here
    check_finite("pair_moments", sd)
    return sd, hits


pair_moments.launches = 0


def _constraint_mask(
    xyz: torch.Tensor,
    other: torch.Tensor,
    threshold: float,
    cross: bool,
    chunk: int,
) -> np.ndarray:
    """Boolean constrained-pair mask, computed on the device.

    CUDA tensors go to :func:`pair_moments` (the kernel), laid out
    contiguously first: centring keeps the strides of a strided input.
    Others take the plain :func:`_distance_sd` in ``chunk``-frame slices.
    Thresholding (and, within one system, self-pair exclusion) happens before
    the fetch so the host transfer is a 1-byte-per-pair mask instead of the
    sd matrix.
    """
    if xyz.device.type == "cuda":
        _, hits = pair_moments(
            xyz.contiguous(), other.contiguous() if cross else None, threshold
        )
        return hits.cpu().numpy()
    hits = _distance_sd(xyz, other, chunk) < threshold
    if not cross:
        hits.fill_diagonal_(False)
    return hits.cpu().numpy()


def _fold_distance_moments(
    xyz: torch.Tensor,  # (t, n, 3) float32
    fold_ids: torch.Tensor,  # (t,) int64 fold of each frame
    n_folds: int,
    chunk: int,
):
    """Per-fold first/second moments of the distance fluctuations.

    One pass over the trajectory yields, for every fold f and site pair,
    sum and sum-of-squares of (d - d0) over fold f's frames — from which
    any train-fold's (= all-but-one-fold) distance sd follows by
    subtraction from the totals. Returns (s1, s2, counts).
    """
    # frame-wise centroid centering: same free-precision trick as
    # guess_pairwise_constraints (distances unchanged, cancellation tamed)
    xyz = xyz - torch.mean(xyz, dim=1, keepdim=True)
    n = xyz.shape[1]
    d0 = _dists(xyz[:1], xyz[:1])[0]
    s1 = xyz.new_zeros((n_folds, n, n))
    s2 = xyz.new_zeros((n_folds, n, n))
    for start in range(0, xyz.shape[0], chunk):
        a = xyz[start : start + chunk]
        fid = fold_ids[start : start + chunk]
        delta = _dists(a, a) - d0
        s1.index_add_(0, fid, delta)
        s2.index_add_(0, fid, delta * delta)
    counts = torch.bincount(fold_ids, minlength=n_folds)
    return s1, s2, counts


def fold_train_constraint_probe(
    xyz,
    folds,
    threshold: float = 1e-3,
    margin_rel: float = 1e-2,
    device: DeviceLike = None,
):
    """Predict per-train-fold constraint detection from one moment pass.

    ``folds`` is a list of held-out frame-index arrays partitioning the
    trajectory. For each fold, the training set's distance sds are derived
    from (total - fold) moments and thresholded exactly like
    :func:`guess_pairwise_constraints`. Returns a list of per-fold
    constraint sets, or None when some pair's train sd falls within
    ``margin_rel`` of the threshold — there the subtraction arithmetic
    (and the subset's different d0 reference) could flip the decision
    relative to running detection on the subset directly, so the caller
    must fall back to exact per-fold detection. ``device`` (default: the
    GPU, or the device of a tensor ``xyz``) is where the moments run.
    """
    dev = resolve_device(device, xyz)
    t, n = xyz.shape[0], xyz.shape[1]
    n_folds = len(folds)
    fold_ids = np.empty(t, dtype=np.int64)
    for f, idx in enumerate(folds):
        fold_ids[idx] = f
    x = torch.as_tensor(xyz, device=dev).to(torch.float32)
    s1, s2, cnt = _fold_distance_moments(
        x,
        torch.as_tensor(fold_ids, device=dev),
        n_folds,
        _chunk_length(t, n, n),
    )
    s1 = s1.cpu().numpy().astype(np.float64)
    s2 = s2.cpu().numpy().astype(np.float64)
    cnt = cnt.cpu().numpy().astype(np.float64)
    tot1, tot2, tot_n = s1.sum(0), s2.sum(0), cnt.sum()
    out = []
    for f in range(n_folds):
        tr1, tr2, tr_n = tot1 - s1[f], tot2 - s2[f], tot_n - cnt[f]
        mean = tr1 / tr_n
        var = np.maximum(tr2 / tr_n - mean * mean, 0.0)
        sds = np.sqrt(var)
        np.fill_diagonal(sds, threshold * 2)
        if np.any(np.abs(sds - threshold) < margin_rel * threshold):
            return None  # ambiguous near the threshold: caller goes exact
        ii, jj = np.nonzero(sds < threshold)
        out.append({frozenset(p) for p in zip(ii.tolist(), jj.tolist())})
    return out


def _centered(x, centroid, dev: torch.device) -> torch.Tensor:
    """``x - centroid`` in the input's precision, then float32 on ``dev``."""
    if isinstance(x, torch.Tensor) or isinstance(centroid, torch.Tensor):
        diff = torch.as_tensor(x, device=dev) - torch.as_tensor(centroid, device=dev)
        return diff.to(torch.float32)
    return torch.as_tensor(np.asarray(x) - centroid, device=dev).to(torch.float32)


@span("aggforce.detect")
def guess_pairwise_constraints(
    xyz,
    cross_xyz=None,
    threshold: float = 1e-3,
    device: DeviceLike = None,
) -> Union[Constraints, set]:
    """Find site pairs whose distance is (nearly) invariant over time.

    Arguments:
    ---------
    xyz:
        (n_frames, n_sites, n_dim) coordinates, numpy or a torch tensor.
    cross_xyz:
        Optional (n_frames, other_n_sites, n_dim). If given, distances between
        the two systems are screened and ordered ``(i, j)`` tuples are
        returned with ``i`` indexing ``cross_xyz`` and ``j`` indexing ``xyz``.
    threshold:
        Pairs with distance standard deviation below this (same units as xyz)
        are considered constrained.
    device:
        Where the moments run: the GPU by default, or the device of a tensor
        ``xyz``.

    Returns:
    -------
    Set of frozensets (within one system) or set of ordered tuples (cross).
    """
    dev = resolve_device(device, xyz, cross_xyz)
    t = xyz.shape[0]
    # translation invariance for free precision, as in the JAX package:
    # centering each frame on its centroid (the same shift for both
    # systems), in the input's precision before the float32 cast, leaves
    # every distance unchanged while shrinking |a| from ~100 nm (unwrapped
    # or uncentered boxes) to molecular scale, so the cast rounds the
    # coordinates at molecular scale too.
    if isinstance(xyz, torch.Tensor):
        xyz = xyz.to(dev)
        centroid = torch.mean(xyz, dim=1, keepdim=True)
    else:
        xyz = np.asarray(xyz)
        centroid = xyz.mean(axis=1, keepdims=True)
    x = _centered(xyz, centroid, dev)
    if cross_xyz is None:
        hits = _constraint_mask(
            x, x, threshold, cross=False, chunk=_chunk_length(t, x.shape[1], x.shape[1])
        )
        ii, jj = np.nonzero(hits)
        return {frozenset(p) for p in zip(ii.tolist(), jj.tolist())}
    other = _centered(cross_xyz, centroid, dev)
    hits = _constraint_mask(
        x, other, threshold, cross=True,
        chunk=_chunk_length(t, x.shape[1], other.shape[1]),
    )
    ii, jj = np.nonzero(hits)
    return {(int(i), int(j)) for i, j in zip(ii, jj)}
