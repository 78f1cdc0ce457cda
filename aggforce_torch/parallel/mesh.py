"""Frame-sharded fits over a 1-D mesh of processes.

Counterpart of the JAX package's ``parallel/mesh.py``. Every Gram and
constraint reduction of a fit is a sum over frames, so each rank reduces its
own contiguous share of the frame axis and one all-reduce combines them; the
small KKT solve then runs identically on every rank:

    [shard frames] -> [local Gram] -> [all_reduce] -> [replicated solve]

The port runs one process per device (SPMD), not one controller over many
devices as JAX does, so a :class:`FrameMesh` is this rank's view of the
mesh: its process group, its device and the frame axis's name. What JAX
writes as a sharding or a collective maps to:

  * ``NamedSharding(mesh, P("frames"))`` of the padded frame axis: rank r
    takes rows ``[r * T_pad / n, (r + 1) * T_pad / n)``
    (:meth:`FrameMesh.shard_bounds`); only that share is uploaded to its
    device. Zero pad frames, masked where the Gram takes a mask, add exact
    zeros;
  * ``psum`` over the axis: :meth:`FrameMesh.all_reduce`;
  * ``all_gather(..., tiled=True)``: :meth:`FrameMesh.all_gather`;
  * ``shard_map`` over sites or fits: each rank solves its slice and one
    all-gather rebuilds the whole result
    (``ops.eqp.batched_eqp_solve_shared_mesh``);
  * a replicated output: every rank returns the whole result.

Every draw a fit takes (constraint frames, folds, noise seeds) is rank 0's,
broadcast (:meth:`FrameMesh.broadcast_array`, :func:`agree_seed`), so every
rank solves the same problem and returns the same map. The collectives take
tensors on the mesh's device, which both NCCL and gloo accept.
"""

from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..utils.device import DeviceLike, resolve_device

FRAME_AXIS = "frames"


class FrameMesh:
    """This rank's view of a 1-D mesh of processes over the frame axis.

    ``group`` is the process group (None: the default group), ``device``
    the device this rank computes on, ``axis_name`` the mesh axis. ``size``
    and ``rank`` are the group's.
    """

    ndim = 1

    def __init__(self, group, device: torch.device, axis_name: str = FRAME_AXIS) -> None:
        self.group = group
        self.device = torch.device(device)
        self.axis_name = axis_name
        self.size = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self._src = 0 if group is None else dist.get_global_rank(group, 0)

    @property
    def mesh_dim_names(self) -> Tuple[str]:
        return (self.axis_name,)

    def get_group(self):
        return self.group

    def shard_bounds(self, n: int) -> Tuple[int, int]:
        """This rank's rows ``[lo, hi)`` of an axis of ``n`` padded to a
        multiple of the mesh size (``hi`` may pass ``n``: the pad)."""
        per = -(-n // self.size)
        return self.rank * per, (self.rank + 1) * per

    def all_reduce(self, x: torch.Tensor, op=dist.ReduceOp.SUM) -> torch.Tensor:
        """Reduce ``x`` over the ranks, in place; returns ``x``."""
        dist.all_reduce(x, op=op, group=self.group)
        return x

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's ``x`` (the same shape on each), concatenated along
        dim 0 in rank order."""
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(self.size)]
        dist.all_gather(parts, x, group=self.group)
        return torch.cat(parts, dim=0)

    def broadcast(self, x: torch.Tensor) -> torch.Tensor:
        """Rank 0's ``x`` on every rank, in place; returns ``x``."""
        dist.broadcast(x, src=self._src, group=self.group)
        return x

    def broadcast_array(self, a: np.ndarray) -> np.ndarray:
        """Rank 0's numpy array (the same shape and dtype on every rank)."""
        x = torch.as_tensor(np.ascontiguousarray(a), device=self.device)
        return self.broadcast(x).cpu().numpy()

    def __repr__(self) -> str:
        return (
            f"FrameMesh(axis={self.axis_name!r}, rank={self.rank}/{self.size}, "
            f"device={self.device})"
        )


def _require_group() -> None:
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            "a mesh needs a torch.distributed process group: call "
            "aggforce_torch.parallel.initialize_distributed() first"
        )


def make_mesh(
    axis_name: str = FRAME_AXIS, device: DeviceLike = None, group=None
) -> FrameMesh:
    """1-D mesh over the processes of ``group`` (default: all of them) for
    frame-data parallelism, this rank computing on ``device``.

    ``device`` None means this process's current CUDA card (the one
    :func:`initialize_distributed` selected for NCCL); pass ``"cpu"`` to run
    on the host, as with gloo. Raises RuntimeError when no process group is
    initialized.
    """
    _require_group()
    if device is None:
        resolve_device(None)  # raises without a card
        device = torch.device("cuda", torch.cuda.current_device())
    return FrameMesh(group, resolve_device(device), axis_name)


def as_frame_mesh(mesh) -> FrameMesh:
    """A fit's ``mesh`` argument, checked: a :class:`FrameMesh`
    (:func:`make_mesh`) over the "frames" axis whose process group is
    initialized. Anything else raises TypeError, a mesh of another axis
    ValueError, and a mesh without a process group RuntimeError.
    """
    if not isinstance(mesh, FrameMesh):
        raise TypeError(
            f"mesh must be a FrameMesh (parallel.make_mesh), not {type(mesh).__name__}"
        )
    if mesh.axis_name != FRAME_AXIS:
        raise ValueError(
            f"the fits shard the {FRAME_AXIS!r} axis; this mesh's axis is "
            f"{mesh.axis_name!r}"
        )
    _require_group()
    return mesh


def mesh_device(mesh: FrameMesh, device: DeviceLike = None) -> torch.device:
    """The device a mesh fit runs on: the mesh's. A ``device`` argument that
    names another raises ValueError."""
    if device is not None:
        want = torch.device(device)
        if want.type != mesh.device.type or (
            want.index is not None and want.index != mesh.device.index
        ):
            raise ValueError(f"device={want} but this rank's mesh device is {mesh.device}")
    return mesh.device


def agree_seed(mesh: FrameMesh, seed: Optional[int]) -> int:
    """Rank 0's seed on every rank: ``seed``, or a fresh draw when None."""
    if seed is None:
        seed = int(np.random.default_rng().integers(0, int(1e6)))
    return int(mesh.broadcast_array(np.array([seed], dtype=np.int64))[0])


def shard_frames(
    mesh: FrameMesh,
    arrays,
    index: Optional[np.ndarray] = None,
    pad: bool = True,
    dtype: torch.dtype = torch.float32,
    length: Optional[int] = None,
):
    """This rank's share of the frames ``index`` (default: every frame) of
    each array in ``arrays`` (numpy or tensors), as ``dtype`` tensors on the
    mesh's device, plus the share's frame mask.

    Only the share is gathered and uploaded. With ``pad`` every rank gets
    the same number of rows: the frame list is padded to ``length`` (default
    its length rounded up to a multiple of the mesh size) with zero frames,
    masked 0 (exact for every Gram here). Without it a rank gets only its
    real frames (possibly none).
    """
    n = len(arrays[0]) if index is None else len(index)
    lo, hi = mesh.shard_bounds(n if length is None else length)
    real_lo, real_hi = min(lo, n), min(hi, n)
    rows = slice(real_lo, real_hi) if index is None else np.asarray(index[real_lo:real_hi])
    n_pad = (hi - real_hi) if pad else 0
    outs = []
    for a in arrays:
        if isinstance(a, torch.Tensor):
            part = a[rows] if index is None else a[torch.as_tensor(rows, device=a.device)]
        else:
            part = np.asarray(a[rows])
        t = torch.as_tensor(part, dtype=dtype, device=mesh.device)
        if n_pad:
            t = torch.cat([t, t.new_zeros((n_pad,) + t.shape[1:])])
        outs.append(t)
    mask = torch.ones(real_hi - real_lo + n_pad, dtype=torch.float32, device=mesh.device)
    if n_pad:
        mask[real_hi - real_lo :] = 0.0
    return (*outs, mask)


def sharded_force_smoothness(array, mesh=None) -> float:
    """Mean squared element with the frame axis sharded over the mesh (each
    rank sums its share in float64; one all-reduce)."""
    fm = as_frame_mesh(make_mesh() if mesh is None else mesh)
    (local, _) = shard_frames(fm, [array], pad=False, dtype=torch.float64)
    total = fm.all_reduce(torch.sum(local * local).reshape(1))
    return float(total.cpu()[0]) / float(np.prod(np.shape(array)))
