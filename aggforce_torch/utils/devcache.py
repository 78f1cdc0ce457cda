"""Content-keyed caches for small device-resident constants.

Counterpart of the JAX package's ``utils/devcache.py``, with the same keys
(shape, dtype, blake2b digest of the bytes; plus the device) and the same
bounds (64 entries, a byte cap of 256 MiB, 128 scalars). On the TPU every
upload is an RPC, so the JAX fits route their constants through it; on the
card a small upload over PCIe costs microseconds, so the port's fits do
not, and the module serves callers that upload the same constants many
times. With no caller in the port, the byte cap is a constant rather than
the JAX package's ``AGGFORCE_DEVCACHE_MB`` override.

torch tensors are mutable where JAX arrays are not: a cached tensor that a
caller changes in place would poison every later hit. Each entry keeps the
tensor's version counter from when it was stored; a hit whose tensor was
written since is dropped and uploaded anew.
"""

import hashlib
from typing import Optional

import numpy as np
import torch

from .device import DeviceLike, resolve_device

__all__ = ["device_const", "device_scalar"]

_CONST_CACHE: dict = {}  # insertion-ordered; LRU via pop+reinsert
_CONST_CACHE_MAX = 64
_CONST_CACHE_MAX_BYTES = 256 * 1024 * 1024
_SCALAR_CACHE: dict = {}
_SCALAR_CACHE_MAX = 128


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def device_const(arr, dtype: Optional[np.dtype] = None, device: DeviceLike = None) -> torch.Tensor:
    """Copy of a small host constant on ``device`` (default: the GPU),
    memoized by content.

    ``dtype=None`` keeps the array's dtype; pass one to cast. Never route
    trajectories through here: hashing them per call would cost more than
    the upload.
    """
    dev = resolve_device(device)
    host = np.ascontiguousarray(arr if dtype is None else np.asarray(arr, dtype=dtype))
    # digest, not raw bytes: a tobytes() key would keep a host copy of
    # every cached constant alive for the cache's lifetime
    digest = hashlib.blake2b(host.tobytes(), digest_size=16).digest()
    key = (digest, host.shape, str(host.dtype), str(dev))
    hit = _CONST_CACHE.pop(key, None)
    if hit is not None and hit[0]._version == hit[1]:
        _CONST_CACHE[key] = hit  # reinsert = most recently used
        return hit[0]
    val = torch.tensor(host, device=dev)  # a copy: never the caller's memory
    _CONST_CACHE[key] = (val, val._version)
    while len(_CONST_CACHE) > _CONST_CACHE_MAX or (
        len(_CONST_CACHE) > 1
        and sum(_nbytes(v) for v, _ in _CONST_CACHE.values()) > _CONST_CACHE_MAX_BYTES
    ):
        del _CONST_CACHE[next(iter(_CONST_CACHE))]
    return val


def device_scalar(x, dtype: torch.dtype = torch.float32, device: DeviceLike = None) -> torch.Tensor:
    """Memoized 0-d device tensor of a fit hyperparameter (same version
    check as :func:`device_const`)."""
    dev = resolve_device(device)
    key = (float(x), dtype, str(dev))
    hit = _SCALAR_CACHE.get(key)
    if hit is not None and hit[0]._version == hit[1]:
        return hit[0]
    if len(_SCALAR_CACHE) >= _SCALAR_CACHE_MAX:
        _SCALAR_CACHE.clear()
    val = torch.tensor(float(x), dtype=dtype, device=dev)
    _SCALAR_CACHE[key] = (val, val._version)
    return val
