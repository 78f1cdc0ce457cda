"""Streaming force-map fits: chunked disk -> host -> device pipelines.

Counterpart of the JAX package's ``io/stream.py``. Fits only ever need one
frame chunk live (every optimization here reduces to a Gram accumulated
over frames plus a small solve), so this module streams chunks from
memory-mapped files (or any array pair) through the device:

    disk (np.memmap) -> pinned host buffer -> H2D on a side stream -> Gram update

On the card two pinned host buffers, allocated once per fit, take turns:
chunk k+1 is read from the memmap into the free buffer and its copy to the
device is issued ``non_blocking`` on a side stream while the compute stream
still reduces chunk k. The compute stream waits on the copy's event before
its Gram update, and the host waits on the same event before it writes into
that buffer again, so a buffer is never refilled under a copy in flight.
Peak host memory is two chunks; peak device memory is a chunk or two plus
the running Gram. A 1M-frame x 3,000-atom trajectory (108 GB) streams
through a card with 80 GB.

The featurized update is the in-memory fit's own Gram path
(:func:`aggforce_torch.qp.fusedfeat._site_gram`), so on the card each chunk
is one launch of the hand-written Gram kernel; the kernel masks the ragged
frame edge, so the last chunk is not padded. The linear update is the
in-memory fit's blockwise Gram (:func:`aggforce_torch.qp.qplinear._linear_gram`).
Both finish with the in-memory fits' solvers and float64 escalations.

With a ``mesh`` (``parallel.make_mesh``, one process per device) each rank
streams its own chunks (its ``frame_slice``, e.g. from
``parallel.process_frame_slice``, or else every n-th chunk of the stream)
into its own device's Gram, and one all-reduce at the finish gives every
rank the global Gram; the solve, its check and its escalation then run
replicated, so every rank returns the same map.
"""

import itertools
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from ..constraints import Constraints
from ..map import CLAFTMap, LinearMap, SeperableTMap, TLinearMap
from ..ops.eqp import converged
from ..parallel.mesh import FrameMesh, as_frame_mesh, mesh_device
from ..qp.fusedfeat import (
    GBFeatSpec,
    _assemble_constraint_system,
    _gram_function,
    _package_fused_map,
    _regularized,
    _site_gram,
    _solve_parts,
    group_factorization,
)
from ..qp.qplinear import (
    _host_linear_fit_from_gram,
    _host_linear_gram,
    _linear_gram,
    _solve_linear_gram,
    constraint_labels,
    make_bond_constraint_matrix,
)
from ..utils.device import DeviceLike, full_fp32, resolve_device


class TrajectoryStream:
    """Chunked view of a trajectory: iterate (coords, forces) frame blocks.

    Sources:
      * ``TrajectoryStream.from_arrays(coords, forces)``: any array pair
        (numpy or memmap); chunks are views.
      * ``TrajectoryStream.from_npy(coords_path, forces_path)``: .npy files
        opened with ``mmap_mode="r"``, so only the chunks read reach RAM.

    ``chunk_size`` bounds the live block. ``n_frames``/``n_sites`` are known
    up front (needed for constraint-frame sampling).
    """

    def __init__(self, coords, forces, chunk_size: int = 4096) -> None:
        if coords.shape != forces.shape:
            raise ValueError("coords and forces must have the same shape.")
        if coords.ndim != 3:
            raise ValueError("expected (n_frames, n_sites, n_dim) arrays.")
        self.coords = coords
        self.forces = forces
        self.chunk_size = int(chunk_size)

    @classmethod
    def from_arrays(cls, coords, forces, chunk_size: int = 4096):
        """Wrap in-memory (or already memory-mapped) arrays."""
        return cls(coords, forces, chunk_size)

    @classmethod
    def from_npy(cls, coords_path: str, forces_path: str, chunk_size: int = 4096):
        """Memory-map two .npy files; chunks are read lazily from disk."""
        return cls(
            np.load(coords_path, mmap_mode="r"),
            np.load(forces_path, mmap_mode="r"),
            chunk_size,
        )

    @property
    def n_frames(self) -> int:
        return self.coords.shape[0]

    @property
    def n_sites(self) -> int:
        return self.coords.shape[1]

    def __len__(self) -> int:
        return self.n_frames

    def chunks(
        self, frame_slice: Optional[slice] = None
    ) -> Iterator[Tuple[np.ndarray, np.ndarray, int]]:
        """Yield (coords_chunk, forces_chunk, n_valid) blocks of ``chunk_size``
        frames; the last one is ragged (``n_valid`` frames, not padded: the
        device updates take any frame count).

        ``frame_slice`` restricts iteration to a contiguous sub-range (the
        multi-process pattern in which each process streams its own frames).
        """
        lo, hi, step = (
            frame_slice.indices(self.n_frames)
            if frame_slice is not None
            else (0, self.n_frames, 1)
        )
        if step != 1:
            raise ValueError("frame_slice must be contiguous (step 1).")
        for start in range(lo, hi, self.chunk_size):
            stop = min(start + self.chunk_size, hi)
            yield self.coords[start:stop], self.forces[start:stop], stop - start

    def gather_frames(self, frame_idx: np.ndarray) -> np.ndarray:
        """Fetch specific frames' coordinates (host side, small)."""
        return np.stack([np.asarray(self.coords[int(i)]) for i in frame_idx])


def _rank_chunks(stream, frame_slice: Optional[slice], mesh: Optional[FrameMesh]):
    """The chunks this rank streams: every chunk of ``frame_slice`` (each
    rank passes its own), or without one every n-th chunk of the stream,
    from the rank's index on (chunks are views, read only when uploaded)."""
    chunks = stream.chunks(frame_slice)
    if mesh is None or frame_slice is not None:
        return chunks
    return itertools.islice(chunks, mesh.rank, None, mesh.size)


class _Uploader:
    """Chunk uploads to ``device``: on the card through two pinned host
    buffers and a side stream (see the module docstring), elsewhere a plain
    float32 copy."""

    def __init__(self, device: torch.device, chunk_size: int, n_sites: int, n_arrays: int):
        self.device = device
        if device.type != "cuda":
            return
        shape = (chunk_size, n_sites, 3)
        self._buffers = [
            [torch.empty(shape, dtype=torch.float32, pin_memory=True) for _ in range(n_arrays)]
            for _ in range(2)
        ]
        self._done: list = [None, None]  # the copy event of each buffer's last upload
        self._side = torch.cuda.Stream(device)
        self._turn = 0

    def upload(self, *arrays: np.ndarray) -> Tuple[torch.Tensor, ...]:
        """The chunk's arrays as float32 tensors on the device, ready for
        work enqueued on the current stream after this call."""
        if self.device.type != "cuda":
            # a copy: a memmap chunk is read-only
            return tuple(
                torch.tensor(np.asarray(a), dtype=torch.float32, device=self.device)
                for a in arrays
            )
        slot = self._turn
        self._turn ^= 1
        if self._done[slot] is not None:
            # the buffer's previous copy must have left before it is refilled
            self._done[slot].synchronize()
        n = arrays[0].shape[0]
        hosts = []
        for buf, a in zip(self._buffers[slot], arrays):
            host = buf[:n]
            np.copyto(host.numpy(), a, casting="same_kind")
            hosts.append(host)
        compute = torch.cuda.current_stream(self.device)
        with torch.cuda.stream(self._side):
            outs = tuple(h.to(self.device, non_blocking=True) for h in hosts)
            done = torch.cuda.Event()
            done.record(self._side)
        compute.wait_event(done)
        for out in outs:
            # allocated on the side stream, consumed on the compute stream
            out.record_stream(compute)
        self._done[slot] = done
        return outs


def streamed_linear_gram(
    stream: TrajectoryStream,
    labels: torch.Tensor,
    r: int,
    frame_slice: Optional[slice] = None,
    mesh: Optional[FrameMesh] = None,
) -> torch.Tensor:
    """(R, R) float32 force Gram of the streamed frames on ``labels``'
    device: one :func:`aggforce_torch.qp.qplinear._linear_gram` per chunk,
    summed in float32; with ``mesh``, this rank's chunks
    (:func:`_rank_chunks`) summed over the ranks."""
    dev = labels.device
    up = _Uploader(dev, stream.chunk_size, stream.n_sites, 1)
    gram = torch.zeros((r, r), dtype=torch.float32, device=dev)
    with full_fp32():
        for _, fc, _ in _rank_chunks(stream, frame_slice, mesh):
            (forces,) = up.upload(fc)
            gram += _linear_gram(forces, labels, r)
    return gram if mesh is None else mesh.all_reduce(gram)


def qp_linear_map_streamed(
    stream: TrajectoryStream,
    coord_map: LinearMap,
    constraints: Optional[Constraints] = None,
    l2_regularization: float = 0.0,
    resid_tol: float = 1e-4,
    mesh=None,
    frame_slice: Optional[slice] = None,
    device: DeviceLike = None,
) -> SeperableTMap:
    """Streamed :func:`aggforce_torch.qp.qp_linear_map` (device backend).

    Accumulates the reduced force Gram chunk by chunk on ``device``
    (default: the GPU); only a chunk or two is ever resident. The solve and
    its check are the in-memory device fit's; a non-finite or unconverged
    solve streams the Gram again in float64 on the host and solves it there
    (over the whole stream when ``frame_slice`` is None, else over the
    slice). ``frame_slice`` restricts the fit to a contiguous frame range.
    Returns ``TLinearMap``s on ``device``.

    With ``mesh`` each rank streams its chunks (its ``frame_slice``, or
    every n-th chunk) and one all-reduce sums the Grams; an escalation then
    solves that global float32 Gram in float64 on every rank (a float64
    re-stream would need a second reduction), as the JAX package does.
    """
    fm = as_frame_mesh(mesh) if mesh is not None else None
    if constraints is None:
        constraints = set()
    dev = resolve_device(device) if fm is None else mesh_device(fm, device)
    labels_np, r = constraint_labels(coord_map.n_fg_sites, constraints)
    labels = torch.as_tensor(labels_np, dtype=torch.int64, device=dev)
    gram = streamed_linear_gram(stream, labels, r, frame_slice, fm)
    cmap_mat = torch.as_tensor(
        np.asarray(coord_map.standard_matrix), dtype=torch.float32, device=dev
    )
    fmap_dev, resid_dev = _solve_linear_gram(
        gram, labels, cmap_mat, float(l2_regularization), r
    )
    fetched = torch.cat([fmap_dev.reshape(-1), resid_dev.reshape(1)]).cpu().numpy()
    fmap_mat = fetched[:-1].reshape(fmap_dev.shape)
    if not converged(fetched[-1], resid_tol, fmap_mat):
        # escalation re-accumulates the Gram in float64 on the host (rare
        # path; correctness over speed); a mesh fit solves its reduced
        # (replicated) Gram in float64
        con_mat = make_bond_constraint_matrix(coord_map.n_fg_sites, constraints)
        if fm is not None:
            gram64 = gram.cpu().numpy().astype(np.float64)
        else:
            gram64 = np.zeros((r, r))
            for _, fc, _ in stream.chunks(frame_slice):
                gram64 += _host_linear_gram(fc, con_mat)
        fmap_mat = _host_linear_fit_from_gram(
            gram64, con_mat, coord_map.standard_matrix, l2_regularization
        )
    return SeperableTMap(
        coord_map=TLinearMap.from_linearmap(coord_map, device=dev),
        force_map=TLinearMap(fmap_mat.astype(np.float32), device=dev),
    )


def streamed_site_grams(
    stream: TrajectoryStream,
    consts: Tuple[torch.Tensor, ...],
    kbt: float,
    spec: GBFeatSpec,
    frame_slice: Optional[slice] = None,
    mesh: Optional[FrameMesh] = None,
) -> torch.Tensor:
    """Per-site featurized Grams (S, K_exp, K_exp) of the streamed frames,
    without the l2 term, summed over the chunks in float64; with ``mesh``,
    this rank's chunks (:func:`_rank_chunks`), and the float64 sum
    all-reduced over the ranks.

    ``consts`` are the fit constants on the fit's device (cmap, group_mean,
    onehot, counts, centers, float32). Each chunk is one
    :func:`aggforce_torch.qp.fusedfeat._site_gram` with the ``"auto"`` Gram,
    so on the card one launch of the Gram kernel per chunk. The chunks'
    float32 Grams are summed in float64, as the kernel sums its own frame
    chunks: at config #3 width over 100,000 frames a float32 running sum
    of the 25 chunk Grams lies 5.3e-7 of the largest entry from a float64
    sum of the frames (3.0e-7 in float64), and the float64 escalation of a
    fit on it lands 1.3e-4 above the optimum instead of 1.5e-5 (PERF.md).
    """
    cmap_mat, group_mean, onehot, counts, centers = consts
    dev = cmap_mat.device
    gram_fn = _gram_function("auto", dev, stream.chunk_size)
    up = _Uploader(dev, stream.chunk_size, stream.n_sites, 2)
    gram = None
    with full_fp32():
        for cc, fc, n_valid in _rank_chunks(stream, frame_slice, mesh):
            coords, forces = up.upload(cc, fc)
            mask = torch.ones(n_valid, dtype=torch.float32, device=dev)
            part = _site_gram(
                coords, forces, mask, cmap_mat, group_mean, onehot, counts, centers,
                float(kbt), spec, gram_fn,
            )
            gram = part.double() if gram is None else gram.add_(part)
    if mesh is None:
        if gram is None:
            raise ValueError("the stream holds no frames")
        return gram
    if gram is None:  # this rank's share holds no chunk
        g = onehot.shape[1]
        k_exp = g * (spec.n_basis + (1 if spec.include_id else 0))
        gram = torch.zeros((cmap_mat.shape[0], k_exp, k_exp), dtype=torch.float64, device=dev)
    return mesh.all_reduce(gram)


def fused_gb_linear_map_streamed(
    stream: TrajectoryStream,
    coord_map: LinearMap,
    kbt: float,
    spec: GBFeatSpec,
    constraints: Optional[Constraints] = None,
    n_constraint_frames: int = 20,
    l2_regularization: float = 1e1,
    constraint_rng: Optional[np.random.Generator] = None,
    resid_tol: float = 1e-4,
    mesh=None,
    frame_slice: Optional[slice] = None,
    device: DeviceLike = None,
) -> CLAFTMap:
    """Streamed canonical featurized fit (id_feat + gb_feat).

    Same optimization as :func:`aggforce_torch.qp.fusedfeat.fused_gb_linear_map`
    with the per-site Grams accumulated chunk by chunk on ``device`` (default:
    the GPU), so the trajectory never needs to fit in host RAM or device
    memory. Constraint frames are sampled up front from the stream's frame
    count (the in-memory fit's draw) and gathered from disk directly; the
    solve, its check and the float64 escalation are the in-memory fit's.

    With ``mesh`` each rank streams its chunks (its ``frame_slice``, or
    every n-th chunk) and one all-reduce sums the float64 Grams; the
    constraint frames are rank 0's draw, and the solve and its escalation
    (on the reduced Gram) run replicated, so every rank returns the same map.
    """
    fm = as_frame_mesh(mesh) if mesh is not None else None
    if constraints is None:
        constraints = set()
    dev = resolve_device(device) if fm is None else mesh_device(fm, device)
    # the group factorization is a function of the topology: no data read
    geom = group_factorization(coord_map, spec, constraints)
    consts = tuple(
        torch.as_tensor(np.asarray(x), dtype=torch.float32, device=dev)
        for x in (
            coord_map.standard_matrix, geom["group_mean"], geom["onehot"],
            geom["counts"], geom["centers"],
        )
    )
    # float64 Grams: the float32 solve takes them rounded, the float64
    # escalation as they are
    gram = _regularized(
        streamed_site_grams(stream, consts, kbt, spec, frame_slice, fm),
        float(l2_regularization),
    )
    rng = constraint_rng if constraint_rng is not None else np.random.default_rng()
    n_cf = min(n_constraint_frames, stream.n_frames)
    frame_idx = rng.choice(stream.n_frames, size=n_cf, replace=False)
    if fm is not None:
        frame_idx = fm.broadcast_array(frame_idx)
    constr_coords = torch.as_tensor(
        stream.gather_frames(frame_idx), dtype=torch.float32, device=dev
    )
    a_rows, b = _assemble_constraint_system(constr_coords, *consts, spec)
    coefs, resids = _solve_parts(gram.float(), a_rows, b)
    return _package_fused_map(
        coefs, torch.amax(resids), gram, a_rows, b, coord_map, geom["onehot"],
        geom["centers"], kbt, spec, resid_tol, dev,
    )
