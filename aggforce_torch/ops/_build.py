"""Build and load the port's CUDA kernels.

Each source under ``aggforce_torch/csrc/`` is compiled by ``nvcc`` for
``sm_90a`` into its own shared library with a plain C interface, on first
use, and loaded with ``ctypes``. The libraries go to ``aggforce_torch/_build/``
under a file name keyed by a hash of the source, the shared headers
(``csrc/*.cuh``) and the flags, so a stale library is never loaded. All
sources are compiled in parallel, one ``nvcc`` process each, under a lock:
a warm-up thread and the main thread that both need the kernels start one
``nvcc`` per source between them.

Nothing here runs at import time: the CPU tests import every module of the
package on a machine without ``nvcc``.
"""

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Dict

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

SOURCES = ("site_grams.cu", "site_grams_tiled.cu")

NVCC_FLAGS = (
    "-gencode",
    "arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-Xptxas",
    "-v",
    "-shared",
    "-Xcompiler",
    "-fPIC",
)

# held while build_all() checks for and compiles the libraries
_BUILD_LOCK = threading.Lock()

# seconds the last build_all() spent compiling (0.0 when every library was
# already built), and what ptxas reported per source
last_build = {"seconds": 0.0, "ptxas": {}}


# where nvcc is looked for when it is not on PATH
NVCC_FALLBACK = Path("/usr/local/cuda/bin/nvcc")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    if NVCC_FALLBACK.exists():
        return str(NVCC_FALLBACK)
    raise RuntimeError(
        "nvcc not found: the CUDA kernels are built on first use and need "
        "the CUDA toolkit (nvcc on PATH or under /usr/local/cuda)."
    )


def library_path(source: str) -> Path:
    """Where the library built from ``source`` lives (keyed by content).

    Every header under ``csrc/`` joins the key, so a header edit rebuilds
    each source that may include it.
    """
    digest = hashlib.sha256()
    digest.update((CSRC / source).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.name.encode())
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    stem = Path(source).stem
    return BUILD_DIR / f"lib{stem}_{digest.hexdigest()[:16]}.so"


def build_all() -> Dict[str, Path]:
    """Compile every source whose library is missing, all in parallel.

    Returns {source: library path}. Raises RuntimeError with the compiler's
    output when a build fails. Calls from several threads take turns, so a
    second caller finds the first one's libraries built.
    """
    with _BUILD_LOCK:
        return _build_missing()


def _build_missing() -> Dict[str, Path]:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    targets = {src: library_path(src) for src in SOURCES}
    todo = {src: lib for src, lib in targets.items() if not lib.exists()}
    t0 = time.perf_counter()
    procs = {}
    nvcc = _nvcc() if todo else None
    for src, lib in todo.items():
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC / src)]
        procs[src] = (
            subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            ),
            tmp,
            lib,
        )
    failures = []
    for src, (proc, tmp, lib) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            os.unlink(tmp)
            failures.append(f"{src}:\n{out}")
            continue
        os.replace(tmp, lib)  # atomic: a reader never sees a partial file
        last_build["ptxas"][src] = out
    if failures:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failures))
    last_build["seconds"] = time.perf_counter() - t0 if todo else 0.0
    return targets


@functools.lru_cache(maxsize=None)
def load(source: str) -> ctypes.CDLL:
    """The loaded library of ``source``, built first if needed."""
    return ctypes.CDLL(str(build_all()[source]))
