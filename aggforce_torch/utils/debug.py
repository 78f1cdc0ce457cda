"""Numerical debug mode: raise at the first non-finite value.

Counterpart of the JAX package's ``utils/debug.py``, which arms JAX's
NaN/Inf tripwires. Here debug mode is a ``TorchDispatchMode`` that checks
the floating outputs of every aten op and raises ``FloatingPointError`` at
the first one holding a NaN (or, with ``infs``, an infinity), naming the
op. The hand-written CUDA kernels are called through ``ctypes`` and bypass
torch's dispatch, so their wrappers (``ops/gram.py``) check their outputs
with :func:`check_finite` while the mode is on. Every checked op waits for
the device: debug mode is for finding where a value goes bad, not for
timing.

Enable per block::

    from aggforce_torch.utils.debug import debug_mode
    with debug_mode():
        project_forces(...)

or for the importing thread with the environment variable
``AGGFORCE_DEBUG=1`` (read once, when :mod:`aggforce_torch.utils.debug` is
first imported).
"""

import contextlib
import os
from typing import List, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

__all__ = ["check_finite", "debug_mode"]

# (nans, infs) of every debug mode entered and not yet left, innermost last
_ACTIVE: List[Tuple[bool, bool]] = []

# ops whose output is uninitialized memory, not a computed value
_UNINITIALIZED = ("empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided")


def _bad(t: torch.Tensor, nans: bool, infs: bool) -> str:
    """"NaN", "Inf" or "" for a tensor's floating values."""
    if not (t.is_floating_point() or t.is_complex()):
        return ""
    if nans and bool(torch.isnan(t).any()):
        return "NaN"
    if infs and bool(torch.isinf(t).any()):
        return "Inf"
    return ""


def check_finite(name: str, tensor: torch.Tensor) -> None:
    """Raise FloatingPointError if a debug mode is on and ``tensor`` holds a
    value it trips on (for results that do not pass through torch's
    dispatch, such as the ctypes kernels')."""
    if not _ACTIVE:
        return
    kind = _bad(tensor, *_ACTIVE[-1])
    if kind:
        raise FloatingPointError(f"{kind} in the output of {name}")


class _NonFiniteCheck(TorchDispatchMode):
    """Checks every aten op's floating outputs."""

    def __init__(self, nans: bool, infs: bool) -> None:
        super().__init__()
        self.nans = nans
        self.infs = infs

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.overloadpacket.__name__ in _UNINITIALIZED:
            return out
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor):
                kind = _bad(t, self.nans, self.infs)
                if kind:
                    raise FloatingPointError(f"{kind} in the output of {func}")
        return out


@contextlib.contextmanager
def debug_mode(nans: bool = True, infs: bool = False):
    """Raise at the first op inside the block whose output holds a NaN
    (and, with ``infs``, an infinity).

    ``infs`` defaults to False because large-but-legitimate intermediate
    magnitudes (force Grams) can overflow transiently in float32 paths that
    are later rescaled.
    """
    _ACTIVE.append((nans, infs))
    try:
        with _NonFiniteCheck(nans, infs):
            yield
    finally:
        _ACTIVE.pop()


if os.environ.get("AGGFORCE_DEBUG") == "1":
    _ACTIVE.append((True, False))
    _NonFiniteCheck(True, False).__enter__()
