r"""Statistical validation of force maps via random basis projections.

Counterpart of the JAX package's ``jaxmapval.py``. Behavior parity target:
reference jaxmapval.py:30-401. Two correctness-without-ground-truth checks:
MSCG inner products of mapped forces against random CG force-fields
(``random_force_proj``), and force-residual shifts relative to a flat field
(``random_residual_shift``); both with random Gaussian-of-squared-distance
potentials as the basis generator (``rsqpg_forces``).

The random offsets are drawn on the host from the caller's numpy
``Generator``, in the reference's order, so a seed gives the JAX package's
numbers (not only their distribution). The force fields are the gradient of
the summed energies, taken by ``torch.func`` over batches of offsets on the
device, and each batch's projections are reduced there: one host read per
batch.
"""

from typing import Callable, Iterable, List, Optional, TypeVar, Union

import numpy as np
import numpy.random as r
import torch

from .agg import force_smoothness
from .ops.torchcore import distances
from .qp.feat import clipped_gauss
from .utils.device import DeviceLike, full_fp32, resolve_device

ArrayT = TypeVar("ArrayT", bound=Union[torch.Tensor, np.ndarray])


def random_uniform_forces(
    positions: np.ndarray,
    scale: float = 1.0,
    randg: Optional[r.Generator] = None,
) -> np.ndarray:
    """Forces of a spatially-uniform random-direction force-field."""
    if randg is None:
        randg = r.default_rng()
    direction = 2 * randg.random(size=3) - 1
    direction /= np.sqrt((direction**2).sum())
    direction *= scale
    t, n, _ = positions.shape
    return np.broadcast_to(direction[None, None, :], (t, n, 3)).copy()


def sq_gaussian_energies(positions: torch.Tensor, offset, width: float) -> torch.Tensor:
    """Per-frame energies: one Gaussian over every squared pairwise distance."""
    distance_arr = distances(positions, return_matrix=True, square=True)
    return clipped_gauss(distance_arr, center=offset, width=width, clip=None).sum(
        dim=(1, 2)
    )


def _neg_energy(positions: torch.Tensor, offset, width: float) -> torch.Tensor:
    return -sq_gaussian_energies(positions, offset, width).sum()


def _positions(positions, device: DeviceLike) -> torch.Tensor:
    """Positions as a tensor on the call's device (numpy in: float32, as the
    JAX package computes them)."""
    dev = resolve_device(device, positions)
    if isinstance(positions, torch.Tensor):
        return positions.to(dev)
    return torch.as_tensor(np.asarray(positions), dtype=torch.float32, device=dev)


def sq_gaussian_forces(
    positions, offset: float, width: float, device: DeviceLike = None
) -> torch.Tensor:
    """Forces (minus the gradient of the summed energies) of one field."""
    return torch.func.grad(_neg_energy)(_positions(positions, device), offset, width)


# batched over a vector of offsets: (B,) x (T, N, 3) -> (B, T, N, 3)
_sq_gaussian_forces_batch = torch.func.vmap(
    torch.func.grad(_neg_energy), in_dims=(None, 0, None)
)


def rsqpg_forces(
    positions,
    inner: float,
    outer: float,
    width: float,
    randg: Optional[r.Generator] = None,
    sq_args: bool = True,
    device: DeviceLike = None,
) -> torch.Tensor:
    """Forces of one random squared-distance Gaussian force-field.

    ``randg`` draws the Gaussian offset uniformly in [inner, outer] (all
    three scale parameters squared first when ``sq_args``).
    """
    if sq_args:
        outer, inner, width = outer**2, inner**2, width**2
    if randg is None:
        randg = r.default_rng()
    offset = randg.random() * (outer - inner) + inner
    return sq_gaussian_forces(positions, offset, width, device=device)


def _draw_offsets(
    n_samples: int,
    randg: r.Generator,
    inner: float,
    outer: float,
    sq_args: bool,
) -> np.ndarray:
    if sq_args:
        inner, outer = inner**2, outer**2
    return randg.random(n_samples) * (outer - inner) + inner


@full_fp32()
def _batched_mscg_ip(forces: torch.Tensor, funcs: torch.Tensor) -> torch.Tensor:
    """Per-sample MSCG inner products: (B,T,N,3) funcs vs (T,N,3) forces."""
    return torch.einsum("btnd,tnd->b", funcs, forces) / forces.shape[0]


def _batched_smoothness(diff: torch.Tensor) -> torch.Tensor:
    return torch.mean(diff**2, dim=(1, 2, 3))


def _as_device(x, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(x, device=like.device).to(like.dtype)


def random_force_proj(
    coords,
    forces,
    n_samples: int = 1000,
    randg: Optional[r.Generator] = None,
    method: Callable[..., torch.Tensor] = rsqpg_forces,
    average: bool = True,
    batch_size: int = 128,
    device: DeviceLike = None,
    **kwargs,
) -> Union[float, Iterable[float]]:
    """Project mapped forces onto ``n_samples`` random CG force-fields.

    For the default ``method`` the fields are evaluated in offset batches
    on the device; other methods are called once per sample.
    """
    if randg is None:
        randg = r.default_rng()
    vals: List[float]
    if method is rsqpg_forces:
        vals = _fast_rsqpg_stats(
            coords, forces, n_samples, randg, batch_size, mode="ip",
            device=device, **kwargs,
        )
    else:
        t = forces.shape[0]
        vals = []
        for _ in range(n_samples):
            trial = method(coords, randg=randg, **kwargs)
            if isinstance(trial, torch.Tensor):
                # reduce on the trial's device: one scalar per sample
                vals.append(float(torch.sum(trial * _as_device(forces, trial)) / t))
            else:
                vals.append(mscg_ip(forces, trial))
    if average:
        return sum(vals) / n_samples
    return vals


def random_residual_shift(
    coords,
    forces,
    n_samples: int = 1000,
    randg: Optional[r.Generator] = None,
    method: Callable[..., torch.Tensor] = rsqpg_forces,
    average: bool = False,
    batch_size: int = 128,
    device: DeviceLike = None,
    **kwargs,
) -> Union[float, List[float]]:
    """Residual differences between random force-fields and a flat field.

    The additive mapping-noise term of the force residual cancels in the
    difference, so two maps of the same system should agree on these shifts
    even though their raw residuals differ.
    """
    if randg is None:
        randg = r.default_rng()
    fs = force_smoothness(forces)
    if method is rsqpg_forces:
        raw = _fast_rsqpg_stats(
            coords, forces, n_samples, randg, batch_size, mode="resid",
            device=device, **kwargs,
        )
        vals = [x - fs for x in raw]
    else:
        vals = []
        for _ in range(n_samples):
            trial = method(coords, randg=randg, **kwargs)
            if isinstance(trial, torch.Tensor):
                diff = _as_device(forces, trial) - trial
                vals.append(float(torch.mean(torch.square(diff))) - fs)
            else:
                vals.append(force_smoothness(forces - np.asarray(trial)) - fs)
    if average:
        return sum(vals) / n_samples
    return vals


def _fast_rsqpg_stats(
    coords,
    forces,
    n_samples: int,
    randg: r.Generator,
    batch_size: int,
    mode: str,
    inner: float = 0.0,
    outer: float = 1.0,
    width: float = 1.0,
    sq_args: bool = True,
    device: DeviceLike = None,
) -> List[float]:
    """Batched evaluation of rsqpg projections/residuals over offsets."""
    offsets = _draw_offsets(n_samples, randg, inner, outer, sq_args)
    w = width**2 if sq_args else width
    tcoords = _positions(coords, device)
    tforces = _as_device(forces, tcoords)
    # the batched gradient keeps a (batch, T, N, N) activation live for the
    # backward pass: cap the batch so that stays within ~2 GB
    t, n = tcoords.shape[0], tcoords.shape[1]
    cap = max(1, (2 << 30) // max(1, t * n * n * 4))
    eff_batch = max(1, min(batch_size, cap, n_samples))
    out: List[float] = []
    for lo in range(0, n_samples, eff_batch):
        batch = _as_device(offsets[lo : lo + eff_batch], tcoords)
        trial = _sq_gaussian_forces_batch(tcoords, batch, w)
        if mode == "ip":
            vals = _batched_mscg_ip(tforces, trial)
        else:
            vals = _batched_smoothness(trial - tforces[None])
        out.extend(float(v) for v in vals.cpu().numpy())
    return out


def mscg_ip(forces: ArrayT, funcs: ArrayT) -> float:
    """MSCG-style inner product: sum(F . G)/n_frames."""
    n_steps = forces.shape[0]
    if isinstance(forces, torch.Tensor) or isinstance(funcs, torch.Tensor):
        like = forces if isinstance(forces, torch.Tensor) else funcs
        return float(torch.sum(_as_device(funcs, like) * _as_device(forces, like)) / n_steps)
    return float((np.asarray(funcs) * np.asarray(forces)).sum() / n_steps)
