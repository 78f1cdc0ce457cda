"""Host -> device staging with per-chunk bandwidth attribution.

Counterpart of the JAX package's ``io/staging.py``. A plain
``torch.as_tensor(big_array, device="cuda")`` gives no way to tell how long
the transfer took or whether the link ran slow; this module makes staging a
measured, attributable phase:

  * **Chunked uploads**: the frame axis is split into ~``chunk_bytes``
    pieces, each copied from pinned host memory and timed on its own, so
    per-chunk bandwidth is observable.
  * **Wire dtype compression**: coordinates/forces can cross the link as
    float16/bfloat16 (half the bytes) and are up-cast to the compute dtype
    on the device. float16 carries ~5e-4 relative quantization (quantified
    by ``tests/test_torch_staging.py``); lossless float32 stays the default.
  * **Bounded retry**: a chunk measuring below the degraded threshold is
    copied once more; the faster copy wins.
  * **Attribution**: the returned :class:`StagingReport` carries wall time,
    measured MB/s, per-chunk extremes, retry count and a ``degraded`` flag.
"""

import os
import time
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils.device import DeviceLike, resolve_device

__all__ = ["StagingReport", "stage_arrays", "stage_trajectory"]

# below this measured bandwidth a chunk counts as slow
DEGRADED_MBPS = 20.0
# a bandwidth sample means something only when the copy ran long enough to
# amortize per-call latency: shorter chunks never trip retries or the flag
_MIN_SAMPLE_SECONDS = 0.25

_WIRE_DTYPES = {
    "float32": torch.float32,
    "float16": torch.float16,
    "bfloat16": torch.bfloat16,
    "float64": torch.float64,
}


@dataclass
class StagingReport:
    """Measured outcome of one staging call."""

    seconds: float = 0.0
    bytes: int = 0
    wire_dtype: str = "float32"
    n_chunks: int = 0
    retries: int = 0
    slow_chunks: int = 0  # chunks with a valid sample below DEGRADED_MBPS
    chunk_mbps_min: float = float("inf")  # over valid samples only
    chunk_mbps_max: float = 0.0
    chunk_seconds: List[float] = field(default_factory=list)

    @property
    def mbps(self) -> float:
        """Aggregate measured bandwidth (MB/s)."""
        if self.seconds <= 0.0:
            return float("inf")
        return self.bytes / self.seconds / 1e6

    @property
    def degraded(self) -> bool:
        """True when a meaningful part of the transfer ran below threshold:
        some chunk with a valid sample measured slow, or the whole job took
        over a second and still averaged below threshold."""
        if self.slow_chunks > 0:
            return True
        return self.seconds > 1.0 and self.mbps < DEGRADED_MBPS

    def merge(self, other: "StagingReport") -> "StagingReport":
        """Combine two reports (sequential phases of one staging job)."""
        return StagingReport(
            seconds=self.seconds + other.seconds,
            bytes=self.bytes + other.bytes,
            wire_dtype=other.wire_dtype,
            n_chunks=self.n_chunks + other.n_chunks,
            retries=self.retries + other.retries,
            slow_chunks=self.slow_chunks + other.slow_chunks,
            chunk_mbps_min=min(self.chunk_mbps_min, other.chunk_mbps_min),
            chunk_mbps_max=max(self.chunk_mbps_max, other.chunk_mbps_max),
            chunk_seconds=self.chunk_seconds + other.chunk_seconds,
        )


def _put_chunk(chunk: torch.Tensor, device: torch.device) -> Tuple[torch.Tensor, float]:
    """Copy one host chunk to ``device`` and wait for it; returns (device
    tensor, seconds of the copy)."""
    t0 = time.perf_counter()
    dev = chunk.to(device, non_blocking=True)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return dev, time.perf_counter() - t0


def _host_chunk(arr, lo: int, hi: int, wire: torch.dtype, pin: bool) -> torch.Tensor:
    """Rows [lo, hi) of ``arr`` in the wire dtype, in pinned memory when
    ``pin``. The conversion runs on the host; float -> float16 saturates
    out-of-range values, which coordinates (1-10) and forces (1e2-1e3)
    never approach."""
    host = torch.tensor(np.asarray(arr[lo:hi])).to(wire)  # a copy: memmaps are read-only
    return host.pin_memory() if pin else host


def stage_arrays(
    arrays: Sequence[np.ndarray],
    wire_dtype: str = "float32",
    compute_dtype: str = "float32",
    chunk_bytes: int = 16 << 20,
    device: DeviceLike = None,
    max_retries: int = 2,
) -> Tuple[List[torch.Tensor], StagingReport]:
    """Stage host arrays to the device in timed chunks along axis 0.

    Arguments:
    ---------
    arrays:
        Host (numpy / memmap) arrays; each is chunked independently along
        its leading axis.
    wire_dtype:
        Dtype of the copies ("float32", "float16", "bfloat16"). The device
        tensors returned are always ``compute_dtype``.
    compute_dtype:
        On-device dtype after the up-cast.
    chunk_bytes:
        Target bytes per chunk (in the wire dtype).
    device:
        Target device (default: the GPU). On the card each chunk is copied
        from pinned memory.
    max_retries:
        Total budget of slow-chunk copies repeated across the call. A chunk
        measuring below DEGRADED_MBPS over a valid sample is copied once
        more while budget remains; the faster copy is kept.

    Returns:
    -------
    (list of device tensors, StagingReport).
    """
    dev = resolve_device(device)
    wire = _WIRE_DTYPES[wire_dtype]
    compute = _WIRE_DTYPES[compute_dtype]
    itemsize = torch.empty((), dtype=wire).element_size()
    report = StagingReport(wire_dtype=str(wire_dtype))
    retries_left = max_retries
    staged: List[torch.Tensor] = []
    for arr in arrays:
        n = arr.shape[0]
        row_bytes = int(np.prod(arr.shape[1:], dtype=np.int64)) * itemsize
        rows_per_chunk = max(1, chunk_bytes // max(row_bytes, 1))
        chunks: List[torch.Tensor] = []
        for lo in range(0, n, rows_per_chunk):
            host = _host_chunk(arr, lo, min(n, lo + rows_per_chunk), wire, dev.type == "cuda")
            out, secs = _put_chunk(host, dev)
            nbytes = host.numel() * itemsize
            mbps = nbytes / max(secs, 1e-9) / 1e6
            if secs >= _MIN_SAMPLE_SECONDS and mbps < DEGRADED_MBPS and retries_left > 0:
                retries_left -= 1
                report.retries += 1
                out2, secs2 = _put_chunk(host, dev)
                if secs2 < secs:
                    out, mbps = out2, nbytes / max(secs2, 1e-9) / 1e6
                secs += secs2
            chunks.append(out)
            report.seconds += secs
            report.bytes += nbytes
            report.n_chunks += 1
            report.chunk_seconds.append(secs)
            if secs >= _MIN_SAMPLE_SECONDS:
                report.chunk_mbps_min = min(report.chunk_mbps_min, mbps)
                report.chunk_mbps_max = max(report.chunk_mbps_max, mbps)
                if mbps < DEGRADED_MBPS:
                    report.slow_chunks += 1
        t0 = time.perf_counter()
        out = torch.cat(chunks, dim=0).to(compute)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        report.seconds += time.perf_counter() - t0
        staged.append(out)
    return staged, report


def stage_trajectory(
    coords: np.ndarray,
    forces: np.ndarray,
    wire_dtype: Optional[str] = None,
    chunk_bytes: int = 16 << 20,
    device: DeviceLike = None,
):
    """Stage a (coords, forces) pair as a device-resident Trajectory.

    ``wire_dtype`` defaults to the ``AGGFORCE_WIRE_DTYPE`` environment
    variable, else lossless float32. Returns (Trajectory, StagingReport).
    """
    from ..trajectory import Trajectory

    if wire_dtype is None:
        wire_dtype = os.environ.get("AGGFORCE_WIRE_DTYPE", "float32")
    (c_dev, f_dev), report = stage_arrays(
        [coords, forces], wire_dtype=wire_dtype, chunk_bytes=chunk_bytes,
        device=device,
    )
    return Trajectory(coords=c_dev, forces=f_dev), report
