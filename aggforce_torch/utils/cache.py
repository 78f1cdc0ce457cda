"""Where the port's CUDA kernels are built and looked up.

Counterpart of the JAX package's ``utils/cache.py``, which points JAX's
persistent compilation cache at a directory. Here the compiled programs
are the hand-written kernels' shared libraries (``ops/_build.py``), keyed
by a hash of their sources and flags, so a directory that already holds
them saves a process the ``nvcc`` runs::

    from aggforce_torch.utils.cache import enable_compile_cache
    enable_compile_cache()                  # AGGFORCE_COMPILE_CACHE, else _build/
    enable_compile_cache("/data/kernels")   # shared across checkouts

Call it before the first kernel launch: a library already loaded stays
loaded from where it was found.
"""

import os
from pathlib import Path
from typing import Optional

__all__ = ["enable_compile_cache"]


def enable_compile_cache(cache_dir: Optional[str] = None) -> str:
    """Build and look up the CUDA kernels' libraries in ``cache_dir``.

    The directory is ``cache_dir``, else the ``AGGFORCE_COMPILE_CACHE``
    environment variable, else the one in use (by default
    ``aggforce_torch/_build/``). It is created if missing; returns its path.
    """
    from ..ops import _build

    target = cache_dir or os.environ.get("AGGFORCE_COMPILE_CACHE") or _build.BUILD_DIR
    target = Path(target).resolve()
    target.mkdir(parents=True, exist_ok=True)
    _build.BUILD_DIR = target
    return str(target)
