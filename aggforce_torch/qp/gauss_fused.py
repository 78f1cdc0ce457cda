"""The staged Gaussian fits with one host sync.

Counterpart of the JAX package's ``qp/jgauss_fused.py``. The staged builders
(reference qp/jgauss.py:143-312, 449-650) chain four device stages: premap
linear fit -> Gaussian augmentation -> real-block premapping (RATMap) ->
second linear fit on the noise sites. Run piecewise
(:func:`aggforce_torch.qp.gauss.stagedjoptgauss_map`), each linear fit waits
for its coefficients and its residual, and each map application for its NaN
verdicts. Here the stages are enqueued back to back and both force maps,
both solver residuals and the noise-contribution diagnostic come back in ONE
device-to-host copy.

Both fits are :func:`aggforce_torch.qp.qplinear._device_linear_fit`, the
piecewise path's own fit, and the augmentation is
:func:`aggforce_torch.trajectory.gaussian._fused_augment_math` on a draw from
a generator seeded like the piecewise augmenter's: on one device the two
paths see the same noise and sum in the same order. A solve that misses the
residual tolerance returns None, and the piecewise path, which owns the
float64 escalation, runs instead.

With a ``mesh`` (``parallel.make_mesh``) each rank takes its contiguous
share of the frames and the same share of the one noise draw (made for every
frame on every rank, so the draw is the single-device one); both fits' Grams
and the noise check's sum are all-reduced, and the solves run replicated.
"""

from typing import Optional

import numpy as np
import torch

from ..ops.eqp import converged
from ..ops.torchcore import trjdot
from ..parallel.mesh import shard_frames
from ..trajectory import gaussian
from ..utils.device import full_fp32
from .qplinear import _device_linear_fit, constraint_labels


@full_fp32()
def _staged_gauss_program(
    coords: torch.Tensor,  # (T, N, 3)
    forces: torch.Tensor,  # (T, N, 3)
    eps: torch.Tensor,  # (T, S*3) standard-normal draw of the augmentation
    cmap_mat: torch.Tensor,  # (S, N)
    labels: torch.Tensor,  # (N,) int64 constraint labels for the premap fit
    r: int,
    fmap1_in: Optional[torch.Tensor],  # (S, N) or None -> fitted here
    var: torch.Tensor,
    kbt: torch.Tensor,
    l2_pre: float,
    l2_post: float,
    zero_stage2: bool,
    reduce=None,
):
    """The whole staged-Gaussian fit, enqueued without a host sync.

    Returns (fmap1, resid1, fmap2, resid2, remaining):
      fmap1   (S, N)  premap force map (input passthrough or fitted)
      resid1  scalar  premap solve constraint violation (0 if passthrough)
      fmap2   (S, 2S) second-stage force map
      resid2  scalar  second-stage violation
      remaining scalar mean squared second-stage-mapped force (the noise
              contribution check of ``stagedjforcegauss_map``)
    ``zero_stage2`` runs the augmentation on a zero-force copy (the
    "force" variant's trick to isolate noise contributions). ``reduce`` sums
    over the ranks of a mesh (``FrameMesh.all_reduce``) when the frames are
    this rank's share.
    """
    if fmap1_in is not None:
        fmap1 = fmap1_in
        resid1 = torch.zeros((), dtype=coords.dtype, device=coords.device)
    else:
        fmap1, resid1 = _device_linear_fit(forces, labels, cmap_mat, l2_pre, r, reduce)

    # the augmentation (pfill=True mirrors the bypass_nan_check premap)
    aug_forces = torch.zeros_like(forces) if zero_stage2 else forces
    _, full_f = gaussian._fused_augment_math(
        eps, coords, aug_forces, var, kbt, cmap_mat, None, pfill=True
    )
    n = coords.shape[1]
    # RATMap: premap the real block's forces (NaN->0, as the handle_nans
    # map of the piecewise path), keep the noise block
    real_f = full_f[:, :n]
    mf_real = trjdot(real_f, fmap1, fill_nan=True)
    pm_f = torch.cat([mf_real, full_f[:, n:]], dim=1)  # (T, 2S, 3)

    # the noise-site fit: no constraints, the slice map [0 | I]
    s_tot = pm_f.shape[1]
    n_aug = cmap_mat.shape[0]
    slice_mat = torch.cat(
        [
            torch.zeros((n_aug, s_tot - n_aug), dtype=pm_f.dtype, device=pm_f.device),
            torch.eye(n_aug, dtype=pm_f.dtype, device=pm_f.device),
        ],
        dim=1,
    )
    ident = torch.arange(s_tot, device=pm_f.device)
    fmap2, resid2 = _device_linear_fit(pm_f, ident, slice_mat, l2_post, s_tot, reduce)
    mapped_sq = torch.square(trjdot(pm_f, fmap2))
    if reduce is None:
        remaining = torch.mean(mapped_sq)
    else:
        total = reduce(torch.stack([mapped_sq.sum(), mapped_sq.new_tensor(mapped_sq.numel())]))
        remaining = total[0] / total[1]
    return fmap1, resid1, fmap2, resid2, remaining


def staged_gauss_fused(
    traj,
    coord_map,
    var: float,
    kbt: float,
    force_map=None,
    constraints=None,
    seed: Optional[int] = None,
    premap_l2_regularization: float = 0.0,
    l2_regularization: float = 0.0,
    zero_stage2: bool = False,
    resid_tol: float = 1e-4,
    mesh=None,
):
    """Run the staged-Gaussian fits with one host sync; None if they do not apply.

    Applicability: float32 tensor trajectory, linear (or absent) premap force
    map. Returns (pre_tmap, pmapped_tmap, remaining) with the structure the
    piecewise builders assemble, or None when the caller should take the
    piecewise path (including when a solve misses ``resid_tol``: the
    piecewise path owns the float64 escalation). ``mesh`` is a checked
    ``FrameMesh`` (every rank then passes the whole trajectory and the same
    ``seed``).
    """
    from ..map import LinearMap, SeperableTMap, TLinearMap

    coords, forces = traj.coords, traj.forces
    if not isinstance(coords, torch.Tensor) or not isinstance(forces, torch.Tensor):
        return None
    if forces.dtype == torch.float64:
        return None  # the piecewise path fits float64 tensors in float64
    if force_map is not None and not isinstance(force_map, LinearMap):
        return None
    if constraints is None:
        constraints = set()
    dev = forces.device if mesh is None else mesh.device
    dtype = torch.float32
    s = coord_map.n_cg_sites
    labels_np, r = constraint_labels(coord_map.n_fg_sites, constraints)
    if seed is None:
        seed = int(np.random.default_rng().integers(0, int(1e6)))
    # the piecewise augmenter's first draw: same generator, same layout
    eps = gaussian._standard_normal(
        gaussian.make_generator(seed, dev), (coords.shape[0], s * 3), dev, dtype
    )
    if mesh is None:
        coords = coords.to(dtype)
        forces = forces.to(dtype)
    else:
        coords, forces, _ = shard_frames(mesh, [coords, forces], pad=False)
        lo, _ = mesh.shard_bounds(eps.shape[0])
        eps = eps[lo : lo + coords.shape[0]]
    fmap1_in = (
        torch.as_tensor(np.asarray(force_map.standard_matrix), dtype=dtype, device=dev)
        if force_map is not None
        else None
    )
    fmap1, resid1, fmap2, resid2, remaining = _staged_gauss_program(
        coords,
        forces,
        eps,
        torch.as_tensor(np.asarray(coord_map.standard_matrix), dtype=dtype, device=dev),
        torch.as_tensor(labels_np, dtype=torch.int64, device=dev),
        r,
        fmap1_in,
        torch.as_tensor(var, dtype=dtype, device=dev),
        torch.as_tensor(kbt, dtype=dtype, device=dev),
        float(premap_l2_regularization),
        float(l2_regularization),
        zero_stage2,
        None if mesh is None else mesh.all_reduce,
    )
    # ONE device-to-host copy: both maps, both residuals, the noise check
    packed = torch.cat(
        [fmap1.reshape(-1), fmap2.reshape(-1), torch.stack([resid1, resid2, remaining])]
    ).cpu().numpy()
    n1, n2 = fmap1.numel(), fmap2.numel()
    fmap1_np = packed[:n1].reshape(fmap1.shape)
    fmap2_np = packed[n1 : n1 + n2].reshape(fmap2.shape)
    r1, r2, remaining = (float(v) for v in packed[n1 + n2 :])
    if not converged(np.maximum(r1, r2), resid_tol, fmap1_np, fmap2_np):
        return None  # the piecewise path re-runs with float64 escalation

    pre_tmap = SeperableTMap(
        coord_map=TLinearMap.from_linearmap(coord_map, device=dev),
        force_map=(
            TLinearMap(fmap1_np, device=dev)
            if force_map is None
            else TLinearMap.from_linearmap(force_map, device=dev)
        ),
    )
    slice_map = LinearMap(mapping=[[i] for i in range(s, 2 * s)], n_fg_sites=2 * s)
    pmapped_tmap = SeperableTMap(
        coord_map=TLinearMap.from_linearmap(slice_map, device=dev),
        force_map=TLinearMap(fmap2_np, device=dev),
    )
    return pre_tmap, pmapped_tmap, remaining
