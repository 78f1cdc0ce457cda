"""Lightweight tracing/profiling utilities.

Counterpart of the JAX package's ``utils/prof.py``:

  * :class:`PhaseTimer`: nested wall-clock phase timing with a report; at
    each phase's end it waits for the card (``torch.cuda.synchronize()``),
    so queued device work is inside the phase that enqueued it;
  * :func:`device_peaks`: the card's name and its peak allocated and
    reserved memory (the caching allocator's counters);
  * :func:`trace`: a ``torch.profiler`` trace of the host's activity and,
    where there is a card, the card's, written as a Chrome trace;
  * :func:`span`: a named layer of the program (one of :data:`LAYER_SPANS`)
    on the profiler's timeline, so each kernel, copy and host sync can be
    tied to the layer that issued it; free when no profiler runs.
"""

import contextlib
import os
import tempfile
import time
from typing import Dict, List, Optional, Tuple

import torch
import torch.autograd.profiler as _autograd_profiler

__all__ = ["LAYER_SPANS", "PhaseTimer", "device_peaks", "span", "trace"]

# The program's layers, each entered once where its work happens:
#   entry        a public fit's set-up, uploads, fetch of the map, packaging
#   detect       constraints.finder.guess_pairwise_constraints
#   gram         the featurized Gram (fusedfeat._site_gram: kernel 1, kernel
#                2 or the plain twin) and the linear Gram (qplinear._linear_gram)
#   constraints  the featurized constraint rows (fusedfeat._assemble_constraint_system)
#   solve        the ops.eqp device solvers and qplinear._solve_linear_gram
#   escalate     the float64 host solves of unconverged fits
#   apply        FusedGBMap and TLinearMap applied to frames
LAYER_SPANS = (
    "aggforce.entry",
    "aggforce.detect",
    "aggforce.gram",
    "aggforce.constraints",
    "aggforce.solve",
    "aggforce.escalate",
    "aggforce.apply",
)


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


def span(name: str):
    """Mark the block (or, as a decorator, each call) as the program layer
    ``name`` of :data:`LAYER_SPANS`.

    Inside a ``torch.profiler`` session this is
    ``torch.profiler.record_function(name)``: the span lies on the same
    clock as the kernels, copies and CUDA runtime calls the profiler
    records, and each launch inside it belongs to the innermost span. With
    no profiler active it reads one flag and never enters
    ``record_function``, which costs microseconds a span even then.
    """
    if name not in LAYER_SPANS:
        raise ValueError(f"{name!r} is not one of {LAYER_SPANS}")
    return _layer(name)


@contextlib.contextmanager
def _layer(name: str):
    if not _autograd_profiler._is_profiler_enabled:
        yield
        return
    with torch.profiler.record_function(name):
        yield


@contextlib.contextmanager
def trace(logdir: Optional[str] = None):
    """Profile the block with ``torch.profiler`` and write a Chrome trace,
    ``trace.json``, into ``logdir`` (a new temporary directory when None);
    yields the directory. The host's activity is traced, with the
    program's :func:`span` layers over the operators and CUDA calls they
    issued, and the card's too where there is one."""
    from torch.profiler import ProfilerActivity, profile

    target = logdir or tempfile.mkdtemp(prefix="aggforce_trace_")
    os.makedirs(target, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield target
        _device_fence()
    prof.export_chrome_trace(os.path.join(target, "trace.json"))

