"""Joining processes and splitting the frames over them.

Counterpart of the JAX package's ``parallel/distributed.py``. Every fit in
this package reduces to [local Gram] -> [sum over ranks] -> [small
replicated solve], so the scaling path is one process per device (SPMD)
joined by ``torch.distributed``: each process loads and reduces its own
frames, and one all-reduce of the O(K^2) Grams crosses the interconnect.
NCCL serves CUDA devices and gloo the CPU (or several ranks sharing one
card, which NCCL refuses).
"""

import os
from typing import Optional

import torch
import torch.distributed as dist

from .mesh import FRAME_AXIS, FrameMesh, make_mesh


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
) -> None:
    """Join (or bootstrap) the process group of a multi-process run.

    ``coordinator_address`` is ``host:port`` (rank 0 listens there) or any
    ``torch.distributed`` init URL (``tcp://...``, ``file:///path``), and
    then needs ``num_processes`` and ``process_id``. Without it the group is
    taken from the environment ``torchrun`` sets (``MASTER_ADDR``,
    ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``); with neither, and
    ``num_processes`` None or 1, a real world-size-1 group is made on an
    in-memory store, so a single process runs the mesh code paths unchanged.
    ``backend`` defaults to NCCL when CUDA is available and gloo otherwise;
    with NCCL the process takes the card of its ``LOCAL_RANK`` (or rank).
    Calling it again once the group exists does nothing.
    """
    if dist.is_initialized():
        if num_processes is not None and num_processes != dist.get_world_size():
            raise ValueError(
                f"the process group has {dist.get_world_size()} processes, "
                f"not {num_processes}"
            )
        return
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    from_env = all(k in os.environ for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE"))
    if coordinator_address is not None:
        if num_processes is None or process_id is None:
            raise ValueError("coordinator_address needs num_processes and process_id")
        url = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
        kwargs = dict(init_method=url, world_size=num_processes, rank=process_id)
    elif from_env:
        kwargs = dict(
            init_method="env://",
            world_size=-1 if num_processes is None else num_processes,
            rank=-1 if process_id is None else process_id,
        )
    elif num_processes in (None, 1):
        kwargs = dict(store=dist.HashStore(), world_size=1, rank=0)
    else:
        raise ValueError(
            f"{num_processes} processes need a coordinator_address or the "
            "torchrun environment (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK)"
        )
    if backend == "nccl":
        rank = kwargs["rank"] if kwargs["rank"] >= 0 else int(os.environ.get("RANK", 0))
        local = int(os.environ.get("LOCAL_RANK", rank))
        torch.cuda.set_device(local % torch.cuda.device_count())
    dist.init_process_group(backend, **kwargs)


def global_frame_mesh(axis_name: str = FRAME_AXIS, device=None) -> FrameMesh:
    """1-D mesh over every process of the group, one device each (the
    device of :func:`make_mesh`)."""
    return make_mesh(axis_name=axis_name, device=device)


def process_frame_slice(n_frames: int) -> slice:
    """The contiguous frame range this process should load.

    Splits ``n_frames`` as evenly as possible over the processes (earlier
    processes take the remainder), so each process loads only its frames.
    Without a process group the one process takes every frame.
    """
    n_proc = dist.get_world_size() if dist.is_initialized() else 1
    pid = dist.get_rank() if dist.is_initialized() else 0
    base, rem = divmod(n_frames, n_proc)
    start = pid * base + min(pid, rem)
    stop = start + base + (1 if pid < rem else 0)
    return slice(start, stop)
