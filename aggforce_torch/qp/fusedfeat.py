r"""Fused featurized force-map fit on the device (the main path).

Counterpart of the single-device part of the JAX package's
``qp/fusedfeat.py``. For the canonical featurization
(``Multifeaturize([id_feat, gb_feat])``, reference README.md:133-147) the
features factorize over constraint groups:

    feat[t, j, (g)]      = onehot[j, g]                      (id part)
    feat[t, j, (g, k)]   = onehot[j, g] * gauss[t, j, k]     (gb part)

so the Gram/constraint/apply contractions never need the expanded feature
tensor. The fit packs the trajectory into per-group operands, runs the
per-site Gram (the hand-written CUDA kernel on the card, its plain twin on
the CPU), assembles the sampled orthogonality constraints and solves every
site's equality QP with the shared-factor solver, escalating to the float64
host oracle when the float32 solve is not converged.

Map application is fused the same way: each frame chunk computes the
geometry once and emits the mapped forces directly (FusedGBMap.__call__),
with the protocol-compatible scale/trans closures kept for CLAMap API parity.
"""

import os
import time
from dataclasses import dataclass
from functools import partial
from typing import Callable, Optional, Tuple, Union

import numpy as np
import torch

from ..constraints import Constraints
from ..map import CLAFTMap, CLAMap, LinearMap, TLinearMap
from ..ops.eqp import batched_eqp_solve_shared, eqp_solve_host
from ..ops.gram import (
    mirror_tiles,
    pack_operands,
    site_grams,
    site_grams_plain,
    site_grams_tiled,
    site_grams_tiled_plain,
    unpack_gram,
)
from ..trajectory import Trajectory
from ..utils.device import DeviceLike, resolve_device
from .featlinearmap import id_feat


@dataclass(frozen=True)
class GBFeatSpec:
    """Hyperparameters of the Gaussian-basis distance featurization."""

    outer: float
    inner: float = 0.0
    n_basis: int = 10
    width: float = 1.0
    dist_power: float = 0.5
    clip: float = 1e-3
    include_id: bool = True  # prepend the one-hot id features (id_feat)


def _basis_centers(spec: GBFeatSpec) -> np.ndarray:
    pow_grid = np.linspace(
        spec.inner**spec.dist_power, spec.outer**spec.dist_power, spec.n_basis
    )
    return pow_grid ** (1.0 / spec.dist_power)


def _group_feature_blocks(
    coords: torch.Tensor,  # (t, N, 3) chunk
    cg_points: torch.Tensor,  # (t, S, 3)
    group_mean: torch.Tensor,  # (G, N): row g averages the members of group g
    counts: torch.Tensor,  # (G,) group sizes
    centers: torch.Tensor,  # (K,)
    spec: GBFeatSpec,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-GROUP Gaussian basis values and closed-form divergences.

    Smearing assigns every member of a constraint group its group-mean
    position, and channels coincide with groups, so all members share
    identical features and everything reduces to per-group tensors:

        gauss[t, s, g, k]   — basis value of group g's mean position
        div[t, s, g, k, a]  = count[g] * phi_k'(d) * unit_vector
    """
    gpos = torch.einsum("gj,tjd->tgd", group_mean, coords)
    disp = gpos[:, None, :, :] - cg_points[:, :, None, :]  # (t, S, G, 3)
    d = torch.sqrt(torch.sum(disp * disp, dim=-1))  # (t, S, G)
    offset = (d[..., None] - centers) / spec.width  # (t, S, G, K)
    raw = torch.exp(-(offset**2))
    gauss = torch.clamp(raw, min=spec.clip) - spec.clip
    u = disp / torch.clamp(d, min=1e-30)[..., None]
    dphi = torch.where(
        raw > spec.clip, raw * (-2.0 * offset / spec.width), torch.zeros_like(raw)
    )
    div = counts[None, None, :, None, None] * dphi[..., None] * u[..., None, :]
    return gauss, div


def _constraint_rows(
    coords: torch.Tensor,  # (tc, N, 3) sampled frames
    cg_points: torch.Tensor,  # (tc, S, 3)
    cmap_mat: torch.Tensor,  # (S, N)
    group_mean: torch.Tensor,
    onehot: torch.Tensor,
    counts: torch.Tensor,
    centers: torch.Tensor,
    spec: GBFeatSpec,
) -> torch.Tensor:
    """Sampled orthogonality rows per site: (S, tc*S, K_exp)."""
    gauss, _ = _group_feature_blocks(
        coords, cg_points, group_mean, counts, centers, spec
    )
    mg = torch.matmul(cmap_mat, onehot)  # (c, G)
    # rows_gb[t,s,c,(g,k)] = Mg[c,g] * gauss[t,s,g,k]
    rows_gb = mg[None, None, :, :, None] * gauss[:, :, None, :, :]
    tc, s_dim, c_dim = rows_gb.shape[:3]
    rows = rows_gb.reshape(tc, s_dim, c_dim, -1)
    if spec.include_id:
        rows_id = mg[None, None].expand(tc, s_dim, *mg.shape)
        rows = torch.cat([rows_id, rows], dim=-1)
    # flatten (frame, cg-row) into the constraint-row axis, per site
    return rows.transpose(0, 1).reshape(s_dim, tc * c_dim, -1)


def _assemble_constraint_system(
    constr_coords: torch.Tensor,
    cmap_mat: torch.Tensor,
    group_mean: torch.Tensor,
    onehot: torch.Tensor,
    counts: torch.Tensor,
    centers: torch.Tensor,
    spec: GBFeatSpec,
    cmap_rows: Optional[torch.Tensor] = None,
    site_sel: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-site constraint rows (Sb, tc*S, K_exp) and targets (Sb, tc*S).

    The orthogonality system of one fitted site spans all S CG sites: its
    weight function must integrate to delta against every site's
    configurational map, so the row axis is always the full ``cmap_mat``.
    ``cmap_rows`` (Sb, N) restricts only which sites are fitted (a site
    block), and ``site_sel`` (Sb, S) is the one-hot of each block row's
    global site index: row (t, c) of block row s targets site_sel[s, c].
    The default is the full map (Sb == S, site_sel == I).
    """
    rows_map = cmap_mat if cmap_rows is None else cmap_rows
    cg_constr = torch.einsum("sj,tjd->tsd", rows_map, constr_coords)
    a_rows = _constraint_rows(
        constr_coords, cg_constr, cmap_mat, group_mean, onehot, counts,
        centers, spec,
    )
    s_all, s_blk = cmap_mat.shape[0], rows_map.shape[0]
    tc = constr_coords.shape[0]
    sel = (
        torch.eye(s_all, dtype=constr_coords.dtype, device=constr_coords.device)
        if site_sel is None
        else site_sel.to(constr_coords.dtype)
    )
    b = sel[:, None, :].expand(s_blk, tc, s_all).reshape(s_blk, tc * s_all)
    return a_rows, b


def _fit_parts(
    coords: torch.Tensor,  # (T, N, 3)
    forces: torch.Tensor,
    mask: torch.Tensor,  # (T,)
    constr_coords: torch.Tensor,  # (tc, N, 3)
    cmap_mat: torch.Tensor,
    group_mean: torch.Tensor,
    onehot: torch.Tensor,
    counts: torch.Tensor,
    centers: torch.Tensor,
    kbt: float,
    l2_regularization: float,
    spec: GBFeatSpec,
    gram_fn: Callable,
    tiled: bool = False,
    cmap_rows: Optional[torch.Tensor] = None,
    site_sel: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-site QP assembly: (gram, constraint rows, targets).

    The counterpart of the JAX package's ``_pallas_fit_parts``: pack the
    group operands, run the fused Gram ``gram_fn`` (see
    :func:`_gram_function`), permute it into the canonical layout and add
    the l2 term. The kernels mask the ragged frame edge themselves, so
    nothing is padded. ``tiled`` marks a Gram of the tiled contract, which
    takes the raw per-basis centers and per-group weights instead of the
    flat per-column ones. ``cmap_rows``/``site_sel`` fit one site block
    (see :func:`_assemble_constraint_system`).
    """
    rows_map = cmap_mat if cmap_rows is None else cmap_rows
    gpos, cgp, fgp, centers_flat, kcounts = pack_operands(
        coords, forces, mask, rows_map, group_mean, onehot, counts, kbt,
        spec.n_basis, centers,
    )
    params = (centers, kcounts[: gpos.shape[2]]) if tiled else (centers_flat, kcounts)
    gram_pad = gram_fn(
        gpos, cgp, fgp, mask, *params, spec.n_basis, spec.width, spec.clip
    )
    g = group_mean.shape[0]
    gram = unpack_gram(gram_pad, g, spec.n_basis)
    del gram_pad  # a sweep block's padded square is 2 GB; free it before the l2 copy
    if not spec.include_id:
        gram = gram[:, g:, g:]
    k_exp = gram.shape[-1]
    gram = gram + l2_regularization * torch.eye(
        k_exp, dtype=gram.dtype, device=gram.device
    )
    a_rows, b = _assemble_constraint_system(
        constr_coords, cmap_mat, group_mean, onehot, counts, centers, spec,
        cmap_rows=cmap_rows, site_sel=site_sel,
    )
    return gram, a_rows, b


def _fit_coefs(
    coords: torch.Tensor,  # (T, N, 3) float32 on the fit's device
    forces: torch.Tensor,
    frame_idx: torch.Tensor,  # (F,) constraint-frame indices
    cmap_mat, group_mean, onehot, counts, centers, kbt, l2_regularization,
    spec: GBFeatSpec, solver_delta: float, solver_iters: int,
    gram_fn: Callable,
    tiled: bool = False,
    cmap_rows: Optional[torch.Tensor] = None,
    site_sel: Optional[torch.Tensor] = None,
):
    """Whole fit of all sites, or of one site block: constraint-frame
    gather, Gram/constraint assembly and the shared-factor KKT solve (the
    JAX package's ``_fit_coefs_e2e`` and ``_fit_coefs`` in one, and with
    ``cmap_rows``/``site_sel`` its ``_siteblock_fit_body`` and
    ``_fit_coefs_siteblock_e2e``).

    Returns (coefs (Sb, K_exp), per-site residuals (Sb,), gram, a_rows, b),
    all on the device; the QP pieces are fetched only if the float64
    escalation needs them.
    """
    mask = torch.ones(coords.shape[0], dtype=coords.dtype, device=coords.device)
    gram, a_rows, b = _fit_parts(
        coords, forces, mask, coords[frame_idx], cmap_mat, group_mean, onehot,
        counts, centers, kbt, l2_regularization, spec, gram_fn, tiled,
        cmap_rows, site_sel,
    )
    # the same shared-factor solver the batch path uses (with a fit-batch
    # of one), so single fits and batched fits agree per problem
    coefs, resids = batched_eqp_solve_shared(
        gram, a_rows[None], b[None, ..., None], delta=solver_delta,
        iters=solver_iters, return_resid=True,
    )
    return coefs[0, ..., 0], resids[0], gram, a_rows, b


def _fused_apply(
    points: torch.Tensor,  # (t, N, 3) forces to map
    copoints: torch.Tensor,  # (t, N, 3) coordinates (copoints)
    coefs: torch.Tensor,
    cmap_mat, group_mean, onehot, counts, centers, kbt,
    spec: GBFeatSpec,
) -> torch.Tensor:
    """One-pass map application: geometry computed once, (t, S, 3) out."""
    gauss, div = _group_feature_blocks(
        copoints, torch.einsum("sj,tjd->tsd", cmap_mat, copoints), group_mean,
        counts, centers, spec,
    )
    g = onehot.shape[1]
    w = torch.einsum("tsg,jg->tsj", _group_weights(gauss, coefs, g, spec), onehot)
    tr = kbt * torch.einsum("tsgka,sgk->tsa", div, _split_coefs(coefs, g, spec)[1])
    return torch.einsum("tsj,tjd->tsd", w, points) + tr


def _split_coefs(coefs: torch.Tensor, g: int, spec: GBFeatSpec):
    """(id coefficients (S, G) or None, basis coefficients (S, G, K))."""
    coef_id, coef_gb = (coefs[:, :g], coefs[:, g:]) if spec.include_id else (None, coefs)
    return coef_id, coef_gb.reshape(coefs.shape[0], g, spec.n_basis)


def _group_weights(gauss, coefs, g: int, spec: GBFeatSpec) -> torch.Tensor:
    """Per-group scale weights (t, S, G)."""
    coef_id, coef_gb = _split_coefs(coefs, g, spec)
    w_group = torch.einsum("tsgk,sgk->tsg", gauss, coef_gb)
    return w_group if coef_id is None else w_group + coef_id[None]


def _fused_scale(
    copoints, coefs, cmap_mat, group_mean, onehot, counts, centers,
    spec: GBFeatSpec,
) -> torch.Tensor:
    """Per-frame scale weights w[t, s, j] = sum_f feat[t,j,f] coef[s,f].

    Computed per group then broadcast to member atoms through the one-hot.
    """
    cg = torch.einsum("sj,tjd->tsd", cmap_mat, copoints)
    gauss, _ = _group_feature_blocks(
        copoints, cg, group_mean, counts, centers, spec
    )
    w_group = _group_weights(gauss, coefs, onehot.shape[1], spec)
    return torch.einsum("tsg,jg->tsj", w_group, onehot)


def _fused_trans(
    copoints, coefs, cmap_mat, group_mean, onehot, counts, centers, kbt,
    spec: GBFeatSpec,
) -> torch.Tensor:
    """Divergence translation term: (t, S, 3)."""
    cg = torch.einsum("sj,tjd->tsd", cmap_mat, copoints)
    _, div = _group_feature_blocks(
        copoints, cg, group_mean, counts, centers, spec
    )
    coef_gb = _split_coefs(coefs, onehot.shape[1], spec)[1]
    return kbt * torch.einsum("tsgka,sgk->tsa", div, coef_gb)


class FusedGBMap(CLAMap):
    """CLAMap whose scale/trans run the fused torch code on a device.

    The trans term carries the kbt-scaled divergence correction, matching the
    reference decomposition of featurized maps into scale (force mixing) and
    trans (divergence offset) — reference qp/featlinearmap.py:462-530 — and
    the G = force-term + kbt*div construction of the fit objective.
    """

    _APPLY_CHUNK = 4096

    def __init__(
        self,
        coefs,
        cmap_mat: np.ndarray,
        onehot: np.ndarray,
        centers: np.ndarray,
        kbt: float,
        spec: GBFeatSpec,
        tags=None,
        device: DeviceLike = None,
    ) -> None:
        """Store fit artifacts on ``device`` (group structure from the one-hot).

        ``coefs`` may already be a tensor on the device (the fit's output),
        which skips its re-upload.
        """
        dev = resolve_device(device, coefs)
        self.device = dev
        f32 = dict(dtype=torch.float32, device=dev)
        onehot = np.asarray(onehot, dtype=np.float32)
        counts = onehot.sum(axis=0)
        self._coefs = torch.as_tensor(coefs, **f32)
        self._cmap_mat = torch.as_tensor(np.asarray(cmap_mat), **f32)
        self._onehot = torch.as_tensor(onehot, **f32)
        self._counts = torch.as_tensor(counts, **f32)
        self._group_mean = torch.as_tensor(
            (onehot / np.maximum(counts, 1.0)).T, **f32
        )
        self._centers = torch.as_tensor(np.asarray(centers), **f32)
        self._kbt = float(kbt)
        self._spec = spec

        def scale(copoints):
            return _fused_scale(
                self._to_device(copoints), self._coefs, self._cmap_mat,
                self._group_mean, self._onehot, self._counts, self._centers,
                spec,
            ).cpu().numpy()

        def trans(copoints):
            return _fused_trans(
                self._to_device(copoints), self._coefs, self._cmap_mat,
                self._group_mean, self._onehot, self._counts, self._centers,
                self._kbt, spec,
            ).cpu().numpy()

        super().__init__(
            scale=scale,
            trans=trans,
            n_fg_sites=cmap_mat.shape[1],
            n_cg_sites=cmap_mat.shape[0],
            zeroes_check=False,
            tags=tags,
        )

    def _to_device(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.float32, device=self.device)

    def __call__(self, points, copoints):
        """Fused, frame-chunked application (type-preserving).

        Each chunk computes the geometry once and emits the mapped forces
        directly, so long trajectories apply in bounded memory. Tensor
        inputs yield a tensor on the map's device (chunks concatenate there);
        numpy inputs are mapped on the device chunk by chunk and come back as
        numpy, matching CLAMap semantics.
        """
        device_in = isinstance(points, torch.Tensor) or isinstance(
            copoints, torch.Tensor
        )
        t = points.shape[0]
        outs = []
        for lo in range(0, t, self._APPLY_CHUNK):
            hi = min(t, lo + self._APPLY_CHUNK)
            mapped = _fused_apply(
                self._to_device(points[lo:hi]),
                self._to_device(copoints[lo:hi]),
                self._coefs, self._cmap_mat, self._group_mean, self._onehot,
                self._counts, self._centers, self._kbt, self._spec,
            )
            outs.append(mapped if device_in else mapped.cpu().numpy())
        if device_in:
            return outs[0] if len(outs) == 1 else torch.cat(outs, dim=0)
        return np.concatenate(outs, axis=0)


def recognize_canonical_featurizer(featurizer) -> Optional[GBFeatSpec]:
    """Detect the canonical id_feat+gb_feat featurizer and extract its spec.

    Recognized shapes: ``Multifeaturize([id_feat, Curry(gb_feat, ...)])``
    (in either order) and a bare ``Curry(gb_feat, ...)``, with this
    package's ``id_feat`` and ``gb_feat``. Returns None for anything else.
    """
    from ..utils.funcs import Curry
    from .feat import DIVMETHOD_CLOSED, gb_feat as _gb_feat
    from .featlinearmap import Multifeaturize, id_feat as _id_feat

    def curry_spec(obj, include_id: bool) -> Optional[GBFeatSpec]:
        if not (isinstance(obj, Curry) and obj.func is _gb_feat and not obj.args):
            return None
        kw = dict(obj.kwargs)
        # options that do not change the math are irrelevant here
        kw.pop("batch_size", None)
        kw.pop("lazy", None)
        kw.pop("device", None)
        if kw.pop("div_method", DIVMETHOD_CLOSED) != DIVMETHOD_CLOSED:
            return None
        if "outer" not in kw:
            return None
        allowed = {"outer", "inner", "n_basis", "width", "dist_power"}
        if not set(kw) <= allowed:
            return None
        return GBFeatSpec(include_id=include_id, **kw)

    if isinstance(featurizer, Multifeaturize):
        subs = list(featurizer.featurizers)
        if len(subs) == 2 and _id_feat in subs:
            # either ordering: the fitted map is invariant to feature-column
            # permutation, and the fused path uses its own internal layout
            other = subs[1] if subs[0] is _id_feat else subs[0]
            return curry_spec(other, include_id=True)
        return None
    return curry_spec(featurizer, include_id=False)


def group_factorization(
    coord_map: LinearMap, spec: GBFeatSpec, constraints: Constraints
) -> dict:
    """Group-factorized featurization geometry (trajectory-independent).

    The canonical id+gb featurization lives on constraint GROUPS, not
    atoms; this returns the {onehot, group_mean, counts, centers} arrays
    that define it — a pure function of the topology (coordinate map +
    constraint sets) and the basis spec.
    """
    ids = id_feat(None, coord_map, constraints, return_ids=True)
    n_channels = int(ids.max()) + 1
    onehot = np.zeros((coord_map.n_fg_sites, n_channels), dtype=np.float32)
    onehot[np.arange(coord_map.n_fg_sites), ids] = 1.0
    counts = onehot.sum(axis=0)
    group_mean = (onehot / np.maximum(counts, 1.0)).T.astype(np.float32)
    centers = _basis_centers(spec).astype(np.float32)
    return {
        "onehot": onehot,
        "group_mean": group_mean,
        "counts": counts,
        "centers": centers,
    }


def _gram_function(
    use_kernel: Union[bool, str], device: torch.device, chunk_size: int,
    tiled: bool = False,
) -> Callable:
    """The per-site Gram of a fit on ``device``, as the flat k-major square.

    ``"auto"`` is the kernel wrapper (``site_grams``, or ``site_grams_tiled``
    with ``tiled``), which launches the CUDA kernel for CUDA tensors and runs
    the plain twin for CPU tensors. ``True`` demands the kernel and so raises
    off the card; ``False`` is the plain twin, chunked over ``chunk_size``
    frames.
    """
    kernel = site_grams_tiled if tiled else site_grams
    if use_kernel == "auto":
        return kernel
    if use_kernel is True:
        if device.type != "cuda":
            raise ValueError(
                f"use_kernel=True needs a CUDA device; the fit runs on {device}"
            )
        return kernel
    if use_kernel is False:
        if not tiled:
            return partial(site_grams_plain, t_chunk=chunk_size)

        def plain_tiled(gpos, cg, fg, mask, centers, kbt_counts, n_basis, width, clip):
            tiles = site_grams_tiled_plain(
                gpos, cg, fg, mask, centers, kbt_counts, n_basis, width, clip,
                t_chunk=chunk_size,
            )
            return mirror_tiles(tiles, n_basis)

        return plain_tiled
    raise ValueError(f"use_kernel must be 'auto', True or False, not {use_kernel!r}")


def _host_solve(gram, a_rows, b):
    """Float64 LAPACK solves of a stack of sites' QPs, the escalation of
    unconverged float32 solves. Returns (coefs (n, K_exp) float32, each
    site's max equilibrated constraint violation (n,))."""
    gram_h = gram.cpu().numpy().astype(np.float64)
    rows_h = a_rows.cpu().numpy().astype(np.float64)
    b_h = b.cpu().numpy().astype(np.float64)
    coefs = np.stack(
        [
            eqp_solve_host(gram_h[s], rows_h[s], b_h[s][:, None])[:, 0]
            for s in range(gram_h.shape[0])
        ]
    ).astype(np.float32)
    row_norm = np.linalg.norm(rows_h, axis=2, keepdims=True) + 1e-300
    resid = np.max(
        np.abs(
            b_h / row_norm[..., 0]
            - np.einsum("smn,sn->sm", rows_h / row_norm, coefs)
        ),
        axis=1,
    )
    return coefs, resid


def _wrap_fused_map(coefs, coord_map, onehot, centers, kbt, spec, tags, device) -> CLAFTMap:
    """The fitted coefficients (a device tensor or numpy) as a CLAFTMap."""
    force_map = FusedGBMap(
        coefs=coefs,
        cmap_mat=np.asarray(coord_map.standard_matrix, dtype=np.float32),
        onehot=onehot,
        centers=centers,
        kbt=kbt,
        spec=spec,
        tags=tags,
        device=device,
    )
    # device coordinate map so tensor trajectories map without a host
    # round-trip (numpy in -> numpy out is preserved)
    if isinstance(coord_map, LinearMap) and not isinstance(coord_map, TLinearMap):
        coord_map = TLinearMap.from_linearmap(coord_map, device=device)
    return CLAFTMap(coord_map=coord_map, force_map=force_map)


def _package_fused_map(
    coefs, solver_resid, gram, a_rows, b, coord_map, onehot, centers, kbt,
    spec, resid_tol, device,
) -> CLAFTMap:
    """Fetch coefficients + residual (the fit's host sync), escalate
    unconverged solves to float64, and wrap the result as a CLAFTMap."""
    coefs_np = coefs.cpu().numpy()
    resid_val = float(solver_resid)
    escalated = False
    if not np.all(np.isfinite(coefs_np)) or not resid_val <= resid_tol:  # NaN-aware
        escalated = True
        # f32 solves on ill-conditioned feature Grams can fail outright
        # (non-finite) or converge past tolerance while staying finite;
        # either way every site's solve goes to the float64 LAPACK oracle
        coefs_np, resid = _host_solve(gram, a_rows, b)
        resid_val = float(resid.max())
    if not np.all(np.isfinite(coefs_np)):
        raise ValueError("Map optimization failed.")
    return _wrap_fused_map(
        # the device coefficients when the f32 solve stood; escalated fits
        # upload their f64-refined values
        coefs_np if escalated else coefs,
        coord_map, onehot, centers, kbt, spec,
        {"coef_list": list(coefs_np), "solver_resid": resid_val, "escalated": escalated},
        device,
    )


def fused_gb_linear_map(
    traj: Trajectory,
    coord_map: LinearMap,
    kbt: float,
    spec: GBFeatSpec,
    constraints: Optional[Constraints] = None,
    n_constraint_frames: int = 20,
    l2_regularization: float = 1e1,
    chunk_size: int = 2048,
    constraint_rng: Optional[np.random.Generator] = None,
    solver_delta: float = 1e-6,
    solver_iters: int = 40,
    resid_tol: float = 1e-4,
    mesh=None,
    use_kernel: Union[bool, str] = "auto",
    device: DeviceLike = None,
) -> CLAFTMap:
    """Device featurized fit for the canonical id+gb featurization.

    Produces the same optimization as the featurizer protocol with
    ``Multifeaturize([id_feat, gb_feat(**spec)])`` but never materializes
    the expanded feature tensors. ``device`` (default: the GPU, or the
    device of tensor trajectories) is where the fit runs.

    ``use_kernel`` selects the per-site Gram: ``"auto"`` runs the
    hand-written CUDA kernel on a CUDA device and its plain torch twin on the
    CPU; ``False`` forces the plain twin, over frame chunks of
    ``chunk_size``; ``True`` off the card raises.

    Convergence is checked, not assumed: the solver returns the max
    equilibrated constraint violation with the coefficients, and any
    non-finite or unconverged solve above ``resid_tol`` escalates to the
    float64 LAPACK oracle. The achieved residual is recorded in the returned
    map's tags (``tags["solver_resid"]``), and whether the fit escalated in
    ``tags["escalated"]``.
    """
    if mesh is not None:
        raise NotImplementedError(
            "multi-device fits are not ported yet (ROADMAP Queue 1 item 13)"
        )
    if constraints is None:
        constraints = set()
    dev = resolve_device(device, traj.coords, traj.forces)
    gram_fn = _gram_function(use_kernel, dev, chunk_size)
    geom = group_factorization(coord_map, spec, constraints)
    onehot, centers = geom["onehot"], geom["centers"]

    t = len(traj)
    rng = constraint_rng if constraint_rng is not None else np.random.default_rng()
    # short trajectories: cannot sample more distinct constraint frames than
    # exist, so clamp (every frame then anchors the orthogonality rows)
    n_constraint_frames = min(n_constraint_frames, t)
    frame_idx = rng.choice(t, size=n_constraint_frames, replace=False)

    def f32(x):
        return torch.as_tensor(x, dtype=torch.float32, device=dev)

    coefs, resids, gram, a_rows, b = _fit_coefs(
        f32(traj.coords),
        f32(traj.forces),
        torch.as_tensor(frame_idx, device=dev),
        f32(coord_map.standard_matrix),
        f32(geom["group_mean"]),
        f32(onehot),
        f32(geom["counts"]),
        f32(centers),
        float(kbt),
        float(l2_regularization),
        spec,
        solver_delta,
        solver_iters,
        gram_fn,
    )
    return _package_fused_map(
        coefs, torch.amax(resids), gram, a_rows, b, coord_map, onehot, centers,
        kbt, spec, resid_tol, dev,
    )


def fused_gb_linear_map_blocked(
    traj: Trajectory,
    coord_map: LinearMap,
    kbt: float,
    spec: GBFeatSpec,
    constraints: Optional[Constraints] = None,
    n_constraint_frames: int = 20,
    l2_regularization: float = 1e1,
    chunk_size: int = 2048,
    constraint_rng: Optional[np.random.Generator] = None,
    solver_delta: float = 1e-6,
    solver_iters: int = 40,
    resid_tol: float = 1e-4,
    site_block: int = 2,
    use_kernel: Union[bool, str] = "auto",
    mesh=None,
    device: DeviceLike = None,
) -> CLAFTMap:
    """Site-blocked featurized fit for solvated-system (sweep) scale.

    The one-program fit (:func:`fused_gb_linear_map`) holds the full
    (S, K_exp, K_exp) Gram stack; with K_exp = G*(1+n_basis) that is
    S*K_exp^2*4 bytes plus the solver's copies, 21 GB of Grams alone at the
    sweep geometry (1,500 atoms, K_exp = 9,000, S = 66). The per-site QPs are
    independent, so fitting ``site_block`` sites at a time is exact: each
    block's Gram, constraint system and solve are the slices the unblocked
    fit would produce, and peak device memory is bounded by the block. The
    last block is padded by repeating its final site, and the padding is
    dropped.

    The Gram of a block is the tiled one (``ops.gram.site_grams_tiled``): one
    (G_pad, G_pad) basis-block pair at a time, so no K_pad-wide row exists.
    ``use_kernel`` selects it as in :func:`fused_gb_linear_map`: ``"auto"``
    runs the hand-written CUDA kernel on a CUDA device and its plain twin on
    the CPU, ``False`` forces the plain twin over ``chunk_size``-frame
    chunks, ``True`` off the card raises. ``device`` is where the fit runs.

    Block k+1 is computed before block k's results are drained (fetched,
    checked and escalated), a depth-1 pipeline; ``AGGFORCE_SWEEP_PIPELINE=0``
    drains every block at once instead. Both give the same coefficients.

    Escalation is per site, by design: a site whose float32 solve is
    non-finite or misses ``resid_tol`` (NaN-aware) is re-solved by the
    float64 LAPACK oracle, and converged sites keep their device results.
    ``tags["solver_resid"]`` is the max residual over sites after
    escalation, ``tags["escalated"]`` the number of escalated sites and
    ``tags["escalation_seconds"]`` the host time their solves took.
    """
    if mesh is not None:
        raise NotImplementedError(
            "multi-device fits are not ported yet (ROADMAP Queue 1 item 13)"
        )
    if constraints is None:
        constraints = set()
    dev = resolve_device(device, traj.coords, traj.forces)
    gram_fn = _gram_function(use_kernel, dev, chunk_size, tiled=True)
    geom = group_factorization(coord_map, spec, constraints)
    onehot, centers = geom["onehot"], geom["centers"]

    t = len(traj)
    rng = constraint_rng if constraint_rng is not None else np.random.default_rng()
    n_constraint_frames = min(n_constraint_frames, t)
    frame_idx = rng.choice(t, size=n_constraint_frames, replace=False)

    def f32(x):
        return torch.as_tensor(x, dtype=torch.float32, device=dev)

    cmap_np = np.asarray(coord_map.standard_matrix, dtype=np.float32)
    s_all = cmap_np.shape[0]
    sb = max(1, min(site_block, s_all))
    coords, forces = f32(traj.coords), f32(traj.forces)
    frame_idx_dev = torch.as_tensor(frame_idx, device=dev)
    common = (
        f32(cmap_np), f32(geom["group_mean"]), f32(onehot), f32(geom["counts"]),
        f32(centers), float(kbt), float(l2_regularization), spec, solver_delta,
        solver_iters, gram_fn,
    )
    pipelined = os.environ.get("AGGFORCE_SWEEP_PIPELINE", "1") == "1"
    coefs_blocks = []
    resid_max = 0.0
    escalated = 0
    escalation_s = 0.0

    def drain(entry) -> None:
        nonlocal resid_max, escalated, escalation_s
        idx, coefs_b, resid_b, gram_b, rows_b, b_b = entry
        coefs_np = np.array(coefs_b.cpu())[: len(idx)]
        resid_np = np.array(resid_b.cpu())[: len(idx)]
        bad = ~np.isfinite(coefs_np).all(axis=1) | ~(resid_np <= resid_tol)  # NaN-aware
        if bad.any():
            t0 = time.perf_counter()
            sel = torch.as_tensor(np.nonzero(bad)[0], device=gram_b.device)
            coefs_np[bad], resid_np[bad] = _host_solve(gram_b[sel], rows_b[sel], b_b[sel])
            escalated += int(bad.sum())
            escalation_s += time.perf_counter() - t0
        coefs_blocks.append(coefs_np)
        resid_max = max(resid_max, float(resid_np.max()))

    pending = None
    for s0 in range(0, s_all, sb):
        idx = np.arange(s0, min(s0 + sb, s_all))
        pad_idx = np.concatenate([idx, np.repeat(idx[-1:], sb - len(idx))])
        sel = np.zeros((sb, s_all), dtype=np.float32)
        sel[np.arange(sb), pad_idx] = 1.0
        entry = (idx,) + _fit_coefs(
            coords, forces, frame_idx_dev, *common, tiled=True,
            cmap_rows=f32(cmap_np[pad_idx]), site_sel=f32(sel),
        )
        if pending is not None:
            drain(pending)
            pending = None
        if pipelined:
            pending = entry
        else:
            drain(entry)
        del entry
    if pending is not None:
        drain(pending)
    coefs_all = np.concatenate(coefs_blocks, axis=0)
    if not np.all(np.isfinite(coefs_all)):
        raise ValueError("Map optimization failed.")
    return _wrap_fused_map(
        coefs_all, coord_map, onehot, centers, kbt, spec,
        {
            "coef_list": list(coefs_all),
            "solver_resid": resid_max,
            "escalated": escalated,
            "escalation_seconds": escalation_s,
        },
        dev,
    )
