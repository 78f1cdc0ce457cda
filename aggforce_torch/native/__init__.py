"""Native (C++) equality-constrained QP solvers, exposed via ctypes.

``admm_qp.cpp`` is a copy of the JAX package's in-tree replacement for the
reference's external QP solvers (OSQP/SCS behind ``qpsolvers``): a float64
KKT solve with refinement and an OSQP-style ADMM iteration with polish. It
is built on first use with ``g++ -O3 -march=native`` into
``aggforce_torch/_build/``, under a file name keyed by a hash of the source,
the flags and the host, so a binary built on another machine (whose
``-march=native`` code may not run here) is never loaded, and nothing is
written beside the source. The native solvers serve as a host-side backend
of ``qp_linear_map`` (``solver_args={"backend": "native"}``) and as an
algorithmically independent oracle for the device path.
"""

import ctypes
import hashlib
import os
import platform
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

import numpy as np

SRC = Path(__file__).resolve().parent / "admm_qp.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_BUILD_ERROR: Optional[str] = None


def library_path() -> Path:
    """Where the library lives: keyed by the source, the flags and the host."""
    digest = hashlib.sha256()
    digest.update(SRC.read_bytes())
    digest.update(" ".join(CXX_FLAGS).encode())
    host = (platform.node(), platform.machine(), platform.processor())
    digest.update(repr(host).encode())
    return BUILD_DIR / f"libadmm_qp_{digest.hexdigest()[:16]}.so"


def _build(lib: Path) -> Optional[str]:
    """Compile the shared library to ``lib``; returns an error string on failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = ["g++", *CXX_FLAGS, str(SRC), "-o", tmp]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=240)
    except (OSError, subprocess.TimeoutExpired) as e:  # g++ missing/hung
        os.unlink(tmp)
        return f"native build failed: {e}"
    if proc.returncode != 0:
        os.unlink(tmp)
        return f"native build failed: {proc.stderr[-2000:]}"
    os.replace(tmp, lib)  # atomic: a reader never sees a partial file
    return None


def load_native() -> Optional[ctypes.CDLL]:
    """Return the native library, building it on first use (None if impossible)."""
    global _LIB, _BUILD_ERROR
    with _LOCK:
        if _LIB is not None:
            return _LIB
        if _BUILD_ERROR is not None:
            return None
        lib_path = library_path()
        if not lib_path.exists():
            err = _build(lib_path)
            if err is not None:
                _BUILD_ERROR = err
                return None
        try:
            lib = ctypes.CDLL(str(lib_path))
        except OSError as e:
            # never raise out of here: native_available() degrades gracefully
            _BUILD_ERROR = f"native load failed: {e}"
            return None
        dp = np.ctypeslib.ndpointer(dtype=np.float64, flags="C_CONTIGUOUS")
        lib.eqp_kkt_solve.restype = ctypes.c_int
        lib.eqp_kkt_solve.argtypes = [
            dp, dp, dp,
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_double, ctypes.c_int, dp,
        ]
        lib.eqp_admm_solve.restype = ctypes.c_int
        lib.eqp_admm_solve.argtypes = [
            dp, dp, dp,
            ctypes.c_int, ctypes.c_int,
            ctypes.c_double, ctypes.c_double, ctypes.c_double,
            ctypes.c_double, ctypes.c_int, ctypes.c_int, dp,
        ]
        _LIB = lib
        return _LIB


def native_available() -> bool:
    """True when the native solver library can be built/loaded."""
    return load_native() is not None


def native_build_error() -> Optional[str]:
    """Last build failure message, if any."""
    return _BUILD_ERROR


def eqp_solve_native(
    P: np.ndarray,
    A: np.ndarray,
    B: np.ndarray,
    delta: float = 1e-11,
    refine_iters: int = 4,
) -> np.ndarray:
    """Multi-RHS KKT solve in the C++ backend. B is (m, k); returns (n, k).

    Raises RuntimeError when the library cannot be built or loaded.
    """
    lib = load_native()
    if lib is None:
        raise RuntimeError(f"native solver unavailable: {_BUILD_ERROR}")
    P = np.ascontiguousarray(P, dtype=np.float64)
    A = np.ascontiguousarray(A, dtype=np.float64)
    B = np.ascontiguousarray(B, dtype=np.float64)
    if B.ndim == 1:
        B = B[:, None]
    n, m, k = P.shape[0], A.shape[0], B.shape[1]
    # validate before handing raw buffers to C (mismatched strides would
    # read/write out of bounds instead of raising)
    if P.shape != (n, n) or A.shape != (m, n) or B.shape != (m, k):
        raise ValueError(
            f"inconsistent shapes: P {P.shape}, A {A.shape}, B {B.shape}"
        )
    out = np.zeros((n, k), dtype=np.float64)
    rc = lib.eqp_kkt_solve(P, A, B, n, m, k, delta, refine_iters, out)
    if rc != 0:
        raise RuntimeError(f"native KKT solve failed (rc={rc})")
    return out


def admm_solve_native(
    P: np.ndarray,
    A: np.ndarray,
    b: np.ndarray,
    rho: float = 0.1,
    sigma: float = 1e-6,
    alpha: float = 1.6,
    eps_abs: float = 1e-9,
    max_iter: int = 4000,
    polish: bool = True,
) -> np.ndarray:
    """Single-RHS OSQP-style ADMM solve in the C++ backend.

    ``polish=True`` refines the converged ADMM iterate against the KKT
    system (OSQP's polish contract); ``polish=False`` returns the raw
    ADMM iterate — use that when the point is an algorithmically
    independent cross-check of the direct KKT solvers.
    """
    lib = load_native()
    if lib is None:
        raise RuntimeError(f"native solver unavailable: {_BUILD_ERROR}")
    P = np.ascontiguousarray(P, dtype=np.float64)
    A = np.ascontiguousarray(A, dtype=np.float64)
    b = np.ascontiguousarray(np.ravel(b), dtype=np.float64)
    n, m = P.shape[0], A.shape[0]
    if P.shape != (n, n) or A.shape != (m, n) or b.shape != (m,):
        raise ValueError(
            f"inconsistent shapes: P {P.shape}, A {A.shape}, b {b.shape}"
        )
    out = np.zeros(n, dtype=np.float64)
    rc = lib.eqp_admm_solve(
        P, A, b, n, m, rho, sigma, alpha, eps_abs, max_iter, int(polish), out
    )
    if rc < 0:
        raise RuntimeError("native ADMM solve failed")
    return out
