"""Program warm-up: overlap the card's one-time preparation with loading.

Counterpart of the JAX package's ``utils/warmup.py``, which compiles the fit
programs on a background thread while the caller loads its trajectory. On
the card a process's first fit pays instead for:

  * building the hand-written kernels (``ops/_build.build_all``: ``nvcc``,
    seconds, when ``_build/`` holds no library for the sources);
  * creating the CUDA context and lazily loading the kernels' modules;
  * creating cuBLAS/cuSOLVER handles and their workspaces;
  * growing the caching allocator's blocks.

None of it depends on the data's values, only on its shapes. Each warmer
here runs a throwaway fit on zero-filled operands of the real shapes on a
background thread, so the caller's loading overlaps it::

    handle = warm_featurized_fit(n_frames, coord_map, spec, constraints)
    data = load_trajectory(...)        # overlaps the warm-up
    handle.wait()
    fused_gb_linear_map(data, ...)

The builds, the context, the loaded modules and the allocator's blocks are
shared by the process's threads; cuBLAS and cuSOLVER handles are made per
thread, so the caller's first fit still creates its own. The warm-up
records what it spent in ``phases`` ("build", "synth", "fit").
"""

import inspect
import threading
import time
from typing import Optional

import numpy as np
import torch

from ..parallel.mesh import as_frame_mesh, mesh_device
from .device import resolve_device

__all__ = [
    "WarmupHandle",
    "warm_featurized_batch",
    "warm_featurized_fit",
    "warm_gauss_fit",
    "warm_linear_fit",
]


class WarmupHandle:
    """Join handle for a background warm-up; records timing and errors.

    ``phases`` maps phase name -> seconds as the warm-up target records
    them, so a slow warm-up can be attributed to its parts.
    """

    def __init__(self, target, label: str) -> None:
        # fail at construction if the target cannot take the phases dict:
        # inside the thread the TypeError would only be recorded, and the
        # warm-up silently skipped
        try:
            inspect.signature(target).bind(dict())
        except TypeError as e:
            raise TypeError(
                f"warm-up target for {label!r} must accept one positional "
                f"argument (the phases dict); got {target!r}: {e}"
            ) from e
        except ValueError:
            pass  # builtins / C callables without introspectable signatures
        self.label = label
        self.started_at = time.perf_counter()
        self.elapsed: Optional[float] = None
        self.phases: dict = {}
        self.error: Optional[BaseException] = None
        self._thread = threading.Thread(
            target=self._run, args=(target,), daemon=True, name=f"warmup-{label}"
        )
        self._thread.start()

    def _run(self, target) -> None:
        try:
            target(self.phases)
        except Exception as e:  # noqa: BLE001 - recorded for the caller, never raised
            self.error = e
        finally:
            self.elapsed = time.perf_counter() - self.started_at

    def wait(self, timeout: Optional[float] = None) -> float:
        """Block until the warm-up finishes; returns the wait in seconds.

        A failed warm-up is not fatal (the first real fit then prepares
        inline), so its error is recorded on ``self.error``, not raised.
        With a ``timeout`` the join may return while the thread still runs:
        check ``self.done`` before reading ``elapsed`` or ``error``.
        """
        t0 = time.perf_counter()
        self._thread.join(timeout)
        return time.perf_counter() - t0

    @property
    def done(self) -> bool:
        """True once the background thread has finished (or failed)."""
        return not self._thread.is_alive()


def _zero_traj(n_frames: int, n_sites: int, device: torch.device):
    """Throwaway trajectory of the requested shape on ``device``.

    Zeros are safe for every warmed fit: distances hit the 1e-30 guard,
    the features stay finite, the Gram reduces to the l2 ridge, and the
    solve returns finite coefficients; the warmers pass ``resid_tol=inf`` so
    the meaningless residual never sends the throwaway fit to the host.
    """
    from ..trajectory import Trajectory

    zeros = torch.zeros((n_frames, n_sites, 3), dtype=torch.float32, device=device)
    return Trajectory(coords=zeros, forces=zeros.clone())


def _prepare(phases: dict, device: torch.device, n_frames: int, n_sites: int):
    """The common first steps: the kernels' build on the card, then the
    throwaway trajectory, each timed into ``phases``."""
    if device.type == "cuda":
        from ..ops import _build

        t0 = time.perf_counter()
        _build.build_all()
        phases["build"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    traj = _zero_traj(n_frames, n_sites, device)
    phases["synth"] = time.perf_counter() - t0
    return traj


def warm_featurized_fit(
    n_frames: int,
    coord_map,
    spec,
    constraints=None,
    kbt: float = 0.7,
    l2_regularization: float = 1e1,
    n_constraint_frames: int = 20,
    chunk_size: int = 2048,
    solver_iters: int = 40,
    use_kernel="auto",
    mesh=None,
    device=None,
) -> WarmupHandle:
    """Warm the featurized fit (:func:`aggforce_torch.qp.fusedfeat.fused_gb_linear_map`)
    for the given shapes on ``device`` (default: the GPU): the kernels'
    build, then one throwaway fit.

    With ``mesh`` the throwaway fit is the mesh fit, on this rank's share of
    ``n_frames`` (every rank must warm up too: its collectives pair with the
    other ranks', and the caller's next mesh fit must wait for the handle).
    """
    if mesh is not None:
        mesh = as_frame_mesh(mesh)
        device = mesh_device(mesh, device)
    dev = resolve_device(device)

    def work(phases: dict) -> None:
        from ..qp.fusedfeat import fused_gb_linear_map

        traj = _prepare(phases, dev, n_frames, coord_map.n_fg_sites)
        t0 = time.perf_counter()
        fused_gb_linear_map(
            traj, coord_map, kbt=kbt, spec=spec, constraints=constraints,
            n_constraint_frames=n_constraint_frames,
            l2_regularization=l2_regularization, chunk_size=chunk_size,
            constraint_rng=np.random.default_rng(0), solver_iters=solver_iters,
            resid_tol=float("inf"), use_kernel=use_kernel, mesh=mesh, device=dev,
        )
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        phases["fit"] = time.perf_counter() - t0

    return WarmupHandle(work, "featurized-fit")


def warm_featurized_batch(
    n_frames: int,
    coord_map,
    spec,
    constraints=None,
    batch: int = 16,
    kbt: float = 0.7,
    l2_regularization: float = 1e1,
    n_constraint_frames: int = 20,
    chunk_size: int = 2048,
    solver_iters: int = 40,
    use_kernel="auto",
    device=None,
) -> WarmupHandle:
    """Warm the shared-Gram batch fits
    (:func:`aggforce_torch.qp.fusedfeat.fused_gb_linear_map_batch`) for a
    window of ``batch`` seeds. May run beside :func:`warm_featurized_fit`:
    the kernels' build is locked, so the two start one ``nvcc`` per source."""
    dev = resolve_device(device)

    def work(phases: dict) -> None:
        from ..qp.fusedfeat import fused_gb_linear_map_batch

        traj = _prepare(phases, dev, n_frames, coord_map.n_fg_sites)
        fused_gb_linear_map_batch(
            traj, coord_map, kbt=kbt, spec=spec, seeds=range(batch),
            constraints=constraints, n_constraint_frames=n_constraint_frames,
            l2_regularization=l2_regularization, chunk_size=chunk_size,
            solver_iters=solver_iters, resid_tol=float("inf"),
            use_kernel=use_kernel, flush_every=batch, device=dev,
        )

    return WarmupHandle(work, "featurized-batch")


def warm_linear_fit(
    n_frames: int,
    coord_map,
    constraints=None,
    l2_regularization: float = 0.0,
    device=None,
) -> WarmupHandle:
    """Warm the static linear fit (``qp_linear_map``, device backend)."""
    dev = resolve_device(device)

    def work(phases: dict) -> None:
        from ..qp.qplinear import qp_linear_map

        traj = _prepare(phases, dev, n_frames, coord_map.n_fg_sites)
        qp_linear_map(
            traj, coord_map, constraints=constraints,
            l2_regularization=l2_regularization,
            solver_args={"backend": "device", "resid_tol": float("inf")}, device=dev,
        )

    return WarmupHandle(work, "linear-fit")


def warm_gauss_fit(
    n_frames: int,
    coord_map,
    var: float,
    kbt: float = 0.7,
    constraints=None,
    device=None,
) -> WarmupHandle:
    """Warm the single-stage noised-map fit (``joptgauss_map``)."""
    dev = resolve_device(device)

    def work(phases: dict) -> None:
        from ..qp.gauss import joptgauss_map

        traj = _prepare(phases, dev, n_frames, coord_map.n_fg_sites)
        joptgauss_map(
            traj, coord_map, var=var, kbt=kbt, constraints=constraints, seed=0,
            solver_args={"resid_tol": float("inf")}, device=dev,
        )

    return WarmupHandle(work, "gauss-fit")
