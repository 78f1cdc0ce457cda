r"""Featurized map application on the card: the hand-written CUDA kernel
``csrc/gb_apply.cu``.

A :class:`~aggforce_torch.qp.fusedfeat.FusedGBMap` maps the forces of frame
t to cg site s as

    out[t, s] = sum_j w[t, s, j] f[t, j] + kbt * div[t, s],

where atom j's weight is its group's, w[t, s, j] = w_g[t, s, g(j)]. The sum
over atoms is therefore a sum over groups of the groups' summed forces
fg[t, g], and the kernel forms neither the (t, S, N) weights nor any
(t, S, G, K) block (:func:`gb_apply_witness` is the same formula in plain
torch and float64, with a bound on the kernel's rounding error). :func:`gb_apply` launches it for CUDA tensors; the CPU keeps the
plain ``qp.fusedfeat._fused_apply``.
"""

import ctypes
import functools
from typing import Tuple

import numpy as np
import torch

from ..utils.debug import check_finite
from ..utils.device import full_fp32


@functools.lru_cache(maxsize=None)
def _lib():
    """The library built from ``csrc/gb_apply.cu``, its two C entries typed:
    ``aggforce_gb_apply_slices`` (the group split P, which sizes the
    workspace) and ``aggforce_gb_apply`` (the three launches)."""
    from . import _build

    lib = _build.load("gb_apply.cu")
    lib.aggforce_gb_apply_slices.argtypes = [ctypes.c_int] * 5
    lib.aggforce_gb_apply_slices.restype = ctypes.c_int
    fn = lib.aggforce_gb_apply
    fn.argtypes = (
        [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_double] * 3
        + [ctypes.c_int] + [ctypes.c_void_p] * 5
    )
    fn.restype = ctypes.c_int
    return lib


def group_members(onehot) -> Tuple[np.ndarray, np.ndarray]:
    """Each group's atoms as int32 CSR lists ``(offsets (G + 1,), atoms)``,
    in ascending atom order, from the (N, G) one-hot of a map. Raises
    ValueError unless every atom belongs to exactly one group."""
    onehot = np.asarray(onehot)
    if onehot.ndim != 2 or not np.isin(onehot, (0, 1)).all():
        raise ValueError("the group one-hot must be an (N, G) array of 0s and 1s")
    if not (onehot.sum(axis=1) == 1).all():
        raise ValueError("every atom must belong to exactly one group")
    labels = onehot.argmax(axis=1)
    atoms = np.argsort(labels, kind="stable").astype(np.int32)
    sizes = np.bincount(labels, minlength=onehot.shape[1])
    offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int32)
    return offsets, atoms


def _check_inputs(points, copoints, coefs, cmap_mat, offsets, atoms, counts, centers, spec):
    """Raise unless every operand meets the kernel's contract: tensors of
    float32 (the CSR lists int32, the centers float64), contiguous, of the
    shapes the map's sizes give, all on one CUDA device. The device is
    checked last, so each other refusal shows on any device."""
    ops = {
        "points": points, "copoints": copoints, "coefs": coefs, "cmap_mat": cmap_mat,
        "offsets": offsets, "atoms": atoms, "counts": counts, "centers": centers,
    }
    for name, x in ops.items():
        if not isinstance(x, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor")
        want = {"offsets": torch.int32, "atoms": torch.int32, "centers": torch.float64}.get(
            name, torch.float32
        )
        if x.dtype != want:
            raise ValueError(f"{name} must be {want}, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if points.ndim != 3 or points.shape[-1] != 3 or points.shape[0] < 1:
        raise ValueError(f"points must be (T >= 1, N, 3), got {tuple(points.shape)}")
    if copoints.shape != points.shape:
        raise ValueError(f"copoints {tuple(copoints.shape)} != points {tuple(points.shape)}")
    n_atoms, n_groups = points.shape[1], counts.shape[0] if counts.ndim == 1 else 0
    if n_groups < 1 or offsets.shape != (n_groups + 1,):
        raise ValueError(
            f"counts (G,) and offsets (G + 1,) disagree: {tuple(counts.shape)}, "
            f"{tuple(offsets.shape)}"
        )
    if atoms.shape != (n_atoms,):
        raise ValueError(f"atoms must list the {n_atoms} atoms, got {tuple(atoms.shape)}")
    if cmap_mat.ndim != 2 or cmap_mat.shape[1] != n_atoms:
        raise ValueError(f"cmap_mat must be (S, {n_atoms}), got {tuple(cmap_mat.shape)}")
    if centers.shape != (spec.n_basis,):
        raise ValueError(f"centers must be ({spec.n_basis},), got {tuple(centers.shape)}")
    k_exp = n_groups * (spec.n_basis + int(spec.include_id))
    if coefs.shape != (cmap_mat.shape[0], k_exp):
        raise ValueError(
            f"coefs must be (S, K_exp) = ({cmap_mat.shape[0]}, {k_exp}) for "
            f"G = {n_groups}, n_basis = {spec.n_basis}, include_id = "
            f"{spec.include_id}; got {tuple(coefs.shape)}"
        )
    device = points.device
    for name, x in ops.items():
        if x.device != device:
            raise ValueError(f"{name} is on {x.device}, points on {device}")
    if device.type != "cuda":
        raise ValueError(f"gb_apply runs on a CUDA card, not {device}")


def _slices(t: int, n_atoms: int, s_dim: int, n_groups: int, n_basis: int) -> int:
    """The group split P the library chooses for these sizes on the current
    device; raises for sizes it does not take."""
    n_slices = _lib().aggforce_gb_apply_slices(t, n_atoms, s_dim, n_groups, n_basis)
    if n_slices == 0:
        raise ValueError(
            f"aggforce_gb_apply refused T={t}, N={n_atoms}, S={s_dim}, G={n_groups}, "
            f"n_basis={n_basis}"
        )
    if n_slices < 0:
        raise RuntimeError(f"aggforce_gb_apply_slices failed (cudaError {-n_slices})")
    return n_slices


def workspace_bytes(t: int, n_atoms: int, s_dim: int, n_groups: int, n_basis: int) -> int:
    """Device bytes one :func:`gb_apply` call of ``t`` frames allocates on
    the current device: the float64 group planes (2, G, 3, T), the float64
    slice sums (P, S, 6, T), and the float32 cg positions and output
    (T, S, 3) each."""
    n_slices = _slices(t, n_atoms, s_dim, n_groups, n_basis)
    return 8 * t * (2 * n_groups * 3 + n_slices * s_dim * 6) + 4 * 2 * t * s_dim * 3


@full_fp32()
def gb_apply(
    points: torch.Tensor,  # (T, N, 3) forces to map
    copoints: torch.Tensor,  # (T, N, 3) coordinates
    coefs: torch.Tensor,  # (S, K_exp): id block, then (G, n_basis) g-major
    cmap_mat: torch.Tensor,  # (S, N)
    offsets: torch.Tensor,  # (G + 1,) int32, from group_members
    atoms: torch.Tensor,  # (N,) int32
    counts: torch.Tensor,  # (G,) group sizes
    centers: torch.Tensor,  # (n_basis,) float64, from qp.fusedfeat.exact_centers
    kbt: float,
    spec,
) -> torch.Tensor:
    """Mapped forces (T, S, 3) of a fused featurized map, by the kernel
    ``csrc/gb_apply.cu`` (built on first use). CUDA tensors only: anything
    outside the contract raises before a launch, and so does a launch the
    C entry refuses. Each call adds one to ``gb_apply.launches``. The cg
    positions come from the same full-fp32 product as on the plain path."""
    _check_inputs(points, copoints, coefs, cmap_mat, offsets, atoms, counts, centers, spec)
    t, n_atoms = points.shape[0], points.shape[1]
    s_dim, n_groups = cmap_mat.shape[0], counts.shape[0]
    sizes = f"T={t}, N={n_atoms}, S={s_dim}, G={n_groups}, n_basis={spec.n_basis}"
    dev = points.device
    lib = _lib()
    with torch.cuda.device(dev):
        n_slices = _slices(t, n_atoms, s_dim, n_groups, spec.n_basis)
        cg = torch.einsum("sj,tjd->tsd", cmap_mat, copoints).contiguous()
        gpos = torch.empty((n_groups, 3, t), dtype=torch.float64, device=dev)
        fg = torch.empty((n_groups, 3, t), dtype=torch.float64, device=dev)
        part = torch.empty((n_slices, s_dim, 6, t), dtype=torch.float64, device=dev)
        out = torch.empty((t, s_dim, 3), dtype=torch.float32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.aggforce_gb_apply(
            points.data_ptr(), copoints.data_ptr(), cg.data_ptr(), coefs.data_ptr(),
            offsets.data_ptr(), atoms.data_ptr(), counts.data_ptr(), centers.data_ptr(),
            t, n_atoms, s_dim, n_groups, spec.n_basis, int(spec.include_id),
            float(spec.width), float(spec.clip), float(kbt), n_slices,
            gpos.data_ptr(), fg.data_ptr(), part.data_ptr(), out.data_ptr(), stream,
        )
    if err < 0:
        raise ValueError(f"aggforce_gb_apply refused {sizes}, slices={n_slices}")
    if err > 0:
        raise RuntimeError(f"aggforce_gb_apply kernel launch failed (cudaError {err})")
    gb_apply.launches += 1
    # the kernel bypasses torch's dispatch, so debug mode checks it here
    check_finite("gb_apply", out)
    return out


gb_apply.launches = 0


# fp32 unit roundoff
_U = 2.0**-24


@full_fp32()
def gb_apply_witness(
    points, copoints, coefs, cmap_mat, onehot, counts, centers, kbt, spec,
    frame_chunk=64, fp32_geometry=False,
):
    """The kernel's formula in plain torch and float64, with the error its
    arithmetic may make: ``(value, bound, scale)``, each (T, S, 3). Give it
    the centers the kernel takes (``qp.fusedfeat.exact_centers``).

    ``value`` is the group sum: the group-mean geometry and basis of
    ``qp.fusedfeat._group_feature_blocks``, the group weights times the
    groups' summed forces, and the divergence as count * (sum_k dphi_k c_k)
    * u; it equals the plain ``_fused_apply``'s atom sums. It forms
    (t, S, G, K) blocks of ``frame_chunk`` frames, so it is a witness for
    tests and checks, not a path.

    ``bound`` is a first-order bound, doubled, on |kernel - value| from
    the kernel's roundings (u = 2^-24, e = 2^-53; X the frame's largest
    |coordinate|; the cg positions' fp32 product off by at most m u r X, m
    the most atoms and r the largest absolute sum of a cg row, and exact
    where each row selects one atom): d off by sqrt(3) m u r X + 2^-50
    (d + X) and each offset by that / width + 2^-50 |o| (fp64 geometry);
    raw = expf(-fl32(o^2)) by 4 u (expf's 2 ulp), u o^2 and 2 |o| times the
    offset's error; gz and dphi by that error carried through, plus raw
    2|o|/width where o^2 lies that close to -ln(clip) (the clip rule's
    edge); the fp64 K-term and group sums, the unit vector and the group
    force by e of their terms' magnitudes; the result's rounding to fp32.
    With ``fp32_geometry`` the bound is that of the plain path's fp32
    arithmetic instead (e = u): d off by u (4 d + (8 + 2 m) X), each offset
    by 3 u |o| plus that and its center's float32 rounding u |c| / width, gz by u gz more, the clip rule's edge
    where |raw - clip| is within raw's error, and the fp32 sums of a stage
    of 32 groups by 33 u of their terms' magnitudes. ``scale`` is the sum of
    the terms' magnitudes, sum_g |w_g fg| + kbt count |dv u|, against which
    a plain fp32 sum over n terms is off by at most n u ``scale``.
    """
    f64 = dict(dtype=torch.float64, device=points.device)
    onehot = torch.as_tensor(onehot, **f64)
    counts = torch.as_tensor(counts, **f64)
    cmap = torch.as_tensor(cmap_mat, **f64)
    centers = torch.as_tensor(centers, **f64)
    coefs = torch.as_tensor(coefs, **f64)
    g, w, clip = onehot.shape[1], float(spec.width), float(spec.clip)
    coef_gb = (coefs[:, g:] if spec.include_id else coefs).reshape(coefs.shape[0], g, -1)
    coef_id = coefs[:, :g] if spec.include_id else torch.zeros_like(coefs[:, :g])
    abs_gb = coef_gb.abs()
    mean = onehot / counts.clamp_min(1.0)
    row_atoms = float((cmap != 0).sum(dim=1).max())
    # of X; 0 when each cg row selects one atom (the product is then exact)
    selects = bool(((cmap == 0) | (cmap == 1)).all()) and row_atoms == 1
    err_cg = 0.0 if selects else row_atoms * _U * float(cmap.abs().sum(dim=1).max())
    n_basis = coef_gb.shape[-1]
    live_off2 = -float(np.log(clip)) if clip > 0 else float("inf")
    values, bounds, scales = [], [], []
    for lo in range(0, points.shape[0], frame_chunk):
        f = torch.as_tensor(points[lo : lo + frame_chunk], **f64)
        x = torch.as_tensor(copoints[lo : lo + frame_chunk], **f64)
        gpos = torch.einsum("jg,tjd->tgd", mean, x)
        fg = torch.einsum("jg,tjd->tgd", onehot, f)
        fg_abs = torch.einsum("jg,tjd->tgd", onehot, f.abs())
        cg = torch.einsum("sj,tjd->tsd", cmap, x)
        xmax = x.abs().amax(dim=(1, 2))[:, None, None]  # (t, 1, 1)
        disp = gpos[:, None, :, :] - cg[:, :, None, :]  # (t, S, G, 3)
        d = torch.sqrt(torch.sum(disp * disp, dim=-1))
        dm = torch.clamp(d, min=1e-30)
        unit = disp / dm[..., None]
        off = (d[..., None] - centers) / w  # (t, S, G, K)
        raw = torch.exp(-(off**2))
        gz = torch.clamp(raw, min=clip) - clip
        dphi = torch.where(raw > clip, raw * (-2.0 * off / w), 0.0)
        w_group = torch.einsum("tsgk,sgk->tsg", gz, coef_gb) + coef_id
        dv = torch.einsum("tsgk,sgk->tsg", dphi, coef_gb)
        div = kbt * counts[:, None] * dv[..., None] * unit  # (t, S, G, 3)
        force = w_group[..., None] * fg[:, None]
        value = force.sum(dim=2) + div.sum(dim=2)

        if fp32_geometry:  # the plain path: fp32 geometry, features and sums
            e = _U
            err_d = _U * (4.0 * d + (8.0 + 2.0 * row_atoms) * xmax)
            err_off = 3.0 * _U * off.abs() + (err_d[..., None] + _U * centers.abs()) / w
            err_disp = _U * disp.abs() + (8.0 + 2.0 * row_atoms) * _U * xmax[..., None]
            err_raw = raw * (4.0 * _U + _U * off**2 + 2.0 * off.abs() * err_off)
            err_gz = err_raw + _U * gz
            near = (raw - clip).abs() <= err_raw
            err_dphi = 2.0 / w * (err_raw * off.abs() + raw * (err_off + 2.0 * _U * off.abs()))
        else:  # the kernel: fp64 but for the exponentials' fp32 argument and result
            e = 2.0**-53
            err_d = 3.0**0.5 * err_cg * xmax + 2.0**-50 * (d + xmax)
            err_off = err_d[..., None] / w + 2.0**-50 * off.abs()
            err_disp = (err_cg + 2.0**-50) * xmax[..., None] + e * disp.abs()
            err_raw = raw * (4.0 * _U + _U * off**2 + 2.0 * off.abs() * err_off)
            err_gz = err_raw
            near = (off**2 - live_off2).abs() <= 2.0 * off.abs() * err_off + 2.0**-40
            err_dphi = 2.0 / w * (err_raw * off.abs() + raw * err_off)
        # a term that close to the clip rule's edge may fall on its other side
        err_dphi = err_dphi + torch.where(near, raw * 2.0 * off.abs() / w, 0.0)
        err_w = torch.einsum("tsgk,sgk->tsg", err_gz, abs_gb) + (n_basis + 1) * e * (
            coef_id.abs() + torch.einsum("tsgk,sgk->tsg", gz.abs(), abs_gb)
        )
        err_dv = torch.einsum("tsgk,sgk->tsg", err_dphi, abs_gb) + n_basis * e * (
            torch.einsum("tsgk,sgk->tsg", dphi.abs(), abs_gb)
        )
        err_unit = torch.where(
            d[..., None] > 0,
            (err_disp + unit.abs() * (err_d + e * d)[..., None]) / dm[..., None]
            + 2.0 * e * unit.abs(),
            0.0,
        )
        kc = kbt * counts[:, None]  # (G, 1)
        err = (
            err_w[..., None] * fg.abs()[:, None] + w_group.abs()[..., None] * 2.0 * e * fg_abs[:, None]
            + kc * (
                err_dv[..., None] * unit.abs() + dv.abs()[..., None] * (err_unit + 2.0 * e * unit.abs())
            )
        ).sum(dim=2)
        scale = force.abs().sum(dim=2) + div.abs().sum(dim=2)
        values.append(value)
        bounds.append(2.0 * (err + 33.0 * e * scale + _U * value.abs()))
        scales.append(scale)
    return torch.cat(values), torch.cat(bounds), torch.cat(scales)
