"""Lightweight tracing/profiling utilities.

Counterpart of the JAX package's ``utils/prof.py``:

  * :class:`PhaseTimer`: nested wall-clock phase timing with a report; at
    each phase's end it waits for the card (``torch.cuda.synchronize()``),
    so queued device work is inside the phase that enqueued it;
  * :func:`device_peaks`: the card's name and its peak allocated and
    reserved memory (the caching allocator's counters);
  * :func:`trace`: a ``torch.profiler`` trace of the card's activity
    (the host's too on a machine without a card), written as a Chrome trace;
  * :func:`log_compile_time`: the first call of a function (kernel builds,
    lazy CUDA module loading, cuBLAS/cuSOLVER handles) reported apart from
    the steady calls.
"""

import contextlib
import os
import tempfile
import time
from functools import wraps
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

__all__ = ["PhaseTimer", "device_peaks", "log_compile_time", "trace"]


def _device_fence() -> None:
    """Wait until all work queued on the card has run (nothing to wait for
    when CUDA was never initialized)."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class PhaseTimer:
    """Accumulates named wall-clock phases; supports nesting and reuse."""

    def __init__(self, sync: bool = True) -> None:
        """``sync=True`` waits for the card at phase exit (timings are real)."""
        self.sync = sync
        self.records: List[Tuple[str, float]] = []
        self._totals: Dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        """Time a named phase (context manager)."""
        start = time.perf_counter()
        try:
            yield self
        finally:
            if self.sync:
                _device_fence()
            elapsed = time.perf_counter() - start
            self.records.append((name, elapsed))
            self._totals[name] = self._totals.get(name, 0.0) + elapsed

    def total(self, name: str) -> float:
        """Accumulated seconds for a phase name."""
        return self._totals.get(name, 0.0)

    def report(self) -> str:
        """Human-readable per-phase totals, longest first."""
        lines = ["phase timings:"]
        for name, total in sorted(self._totals.items(), key=lambda kv: -kv[1]):
            n = sum(1 for r, _ in self.records if r == name)
            lines.append(f"  {name:<32s} {total:9.4f}s  (x{n})")
        return "\n".join(lines)


def device_peaks(device=None) -> Optional[Tuple[str, int, int]]:
    """(device name, peak bytes allocated, peak bytes reserved) of a CUDA
    device (default: the current one) since the last
    ``torch.cuda.reset_peak_memory_stats``; None on the CPU or without a
    card."""
    if device is None:
        if not torch.cuda.is_available():
            return None
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type != "cuda":
        return None
    return (
        torch.cuda.get_device_name(device),
        torch.cuda.max_memory_allocated(device),
        torch.cuda.max_memory_reserved(device),
    )


@contextlib.contextmanager
def trace(logdir: Optional[str] = None):
    """Profile the block with ``torch.profiler`` and write a Chrome trace,
    ``trace.json``, into ``logdir`` (a new temporary directory when None);
    yields the directory. The card's activity is traced where there is a
    card, the host's otherwise (host tracing of long runs is slow to
    aggregate)."""
    from torch.profiler import ProfilerActivity, profile

    target = logdir or tempfile.mkdtemp(prefix="aggforce_trace_")
    os.makedirs(target, exist_ok=True)
    activity = (
        ProfilerActivity.CUDA if torch.cuda.is_available() else ProfilerActivity.CPU
    )
    with profile(activities=[activity]) as prof:
        yield target
        _device_fence()
    prof.export_chrome_trace(os.path.join(target, "trace.json"))


def log_compile_time(fn: Callable, sink: Optional[Callable[[str], Any]] = None):
    """Wrap a callable, reporting its first call (kernel builds, lazy CUDA
    initialization) apart from its steady calls; each call waits for the
    card before its time is taken."""
    state = {"calls": 0}
    emit = sink or print

    @wraps(fn)
    def wrapped(*args, **kwargs):
        start = time.perf_counter()
        out = fn(*args, **kwargs)
        _device_fence()
        elapsed = time.perf_counter() - start
        state["calls"] += 1
        kind = "first call (incl. builds and CUDA set-up)" if state["calls"] == 1 else "call"
        emit(f"[{getattr(fn, '__name__', 'fn')}] {kind}: {elapsed:.4f}s")
        return out

    return wrapped
