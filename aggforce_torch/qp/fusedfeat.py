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
:func:`fused_gb_linear_map_batch` fits one map per constraint-sample seed
and shares one Gram among the seeds of a window.

Each fit takes a ``mesh`` (``parallel.make_mesh``, one process per device):
the frame axis is then split over the ranks, each rank runs the Gram on its
share and one all-reduce sums the per-site Grams before the replicated
solve; the site-blocked fit splits its site blocks over the ranks instead.

Every product here runs at full float32 precision whatever TF32 setting the
process has chosen (``utils.device.full_fp32()`` scopes the entry points and
the helpers that take products), as the JAX code's ``precision="highest"``.

Map application is fused the same way (FusedGBMap.__call__): on the card
one launch of the hand-written kernel ``csrc/gb_apply.cu``
(``ops.gb_apply``) maps a call's frames from per-group quantities; on the
CPU each frame chunk computes the geometry once and emits the mapped forces
directly (:func:`_fused_apply`). The protocol-compatible scale/trans
closures are kept for CLAMap API parity.
"""

import time
import warnings
from dataclasses import dataclass
from functools import partial
from typing import Callable, Optional, Tuple, Union

import numpy as np
import torch

from ..constraints import Constraints
from ..map import CLAFTMap, CLAMap, LinearMap, TLinearMap
from ..ops.eqp import (
    batched_eqp_solve_shared,
    batched_eqp_solve_shared_mesh,
    converged,
    eqp_solve_host,
)
from ..ops.gb_apply import gb_apply, group_members
from ..ops.gram import (
    mirror_tiles,
    pack_operands,
    site_grams,
    site_grams_plain,
    site_grams_tiled,
    site_grams_tiled_plain,
    unpack_gram,
)
from ..parallel.mesh import FrameMesh, as_frame_mesh, mesh_device, shard_frames
from ..trajectory import Trajectory
from ..utils.device import DeviceLike, full_fp32, resolve_device
from ..utils.prof import span
from .featlinearmap import id_feat

# the shared-factor KKT solve's defaults (ridge delta, refinement sweeps)
SOLVER_DELTA = 1e-6
SOLVER_ITERS = 40


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


def exact_centers(centers, spec: GBFeatSpec) -> np.ndarray:
    """A map's basis centers in float64: the spec's own
    (:func:`_basis_centers`) where ``centers`` are their float32 rounding,
    as every fit and loader stores them, else ``centers`` as given.

    The clip rule is a step: a term's derivative drops to 0 where
    exp(-off^2) falls to ``clip``. Offsets from float32 centers (off by up
    to 2e-7 at 5.56 A) put a few terms in a fit on the other side of that
    step from the float64 definition, each a jump of clip * 2|off| / width
    times its coefficient in the mapped force."""
    given = np.asarray(centers, dtype=np.float64)
    exact = _basis_centers(spec)
    if exact.shape == given.shape and np.array_equal(
        exact.astype(np.float32), given.astype(np.float32)
    ):
        return exact
    return given


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
    """Sampled orthogonality rows per site: (S, tc*S, K_exp). Its products
    run in the full-fp32 scope of its caller,
    :func:`_assemble_constraint_system`."""
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


@span("aggforce.constraints")
@full_fp32()
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


def _constraint_system(
    coords: torch.Tensor,  # (T, N, 3)
    frame_idx: torch.Tensor,  # (F,) one fit's constraint frames, or (B, F)
    cmap_mat, group_mean, onehot, counts, centers,
    spec: GBFeatSpec,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The constraint system of the fit whose constraint frames are
    ``frame_idx``: (S, m, K_exp) rows and (S, m) targets, m = F * S. A
    (B, F) batch of fits gives (B, S, m, K_exp) and (B, S, m): its frames
    are assembled together, and each fit's rows are those of its own frames
    (the JAX package's ``_constraint_system_e2e`` and the vmapped assembly
    of ``_fit_coefs_batch_e2e``)."""
    rows, b = _assemble_constraint_system(
        coords[frame_idx.reshape(-1)], cmap_mat, group_mean, onehot, counts,
        centers, spec,
    )
    if frame_idx.ndim == 1:
        return rows, b
    # the row axis is (frame, cg row), frame-major, so fit i owns rows
    # [i * m, (i + 1) * m)
    n_fit, s_dim = frame_idx.shape[0], rows.shape[0]
    return (
        rows.reshape(s_dim, n_fit, -1, rows.shape[-1]).transpose(0, 1),
        b.reshape(s_dim, n_fit, -1).transpose(0, 1),
    )


@span("aggforce.gram")
def _site_gram(
    coords: torch.Tensor,  # (T, N, 3)
    forces: torch.Tensor,
    mask: torch.Tensor,  # (T,)
    rows_map: torch.Tensor,  # (Sb, N) the sites whose Grams are taken
    group_mean: torch.Tensor,
    onehot: torch.Tensor,
    counts: torch.Tensor,
    centers: torch.Tensor,
    kbt: float,
    spec: GBFeatSpec,
    gram_fn: Callable,
    tiled: bool = False,
) -> torch.Tensor:
    """Per-site featurized Gram of the masked frames, (Sb, K_exp, K_exp), in
    the canonical layout of the constraint rows and without the l2 term.

    The one code path from frames to Gram (pack the group operands, run the
    Gram ``gram_fn`` of :func:`_gram_function`, unpack it, drop the id block
    when ``spec`` has none) for the fits, the batch fits and the
    cross validation's fold Grams. The kernels mask the ragged frame edge
    and the masked frames themselves, so nothing is padded. ``tiled`` marks
    a Gram of the tiled contract, which takes the raw per-basis centers and
    per-group weights instead of the flat per-column ones.
    """
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
    return gram if spec.include_id else gram[:, g:, g:]


def _regularized(gram: torch.Tensor, l2_regularization: float) -> torch.Tensor:
    """``gram`` plus the l2 term on its diagonal (a new tensor)."""
    k_exp = gram.shape[-1]
    return gram + l2_regularization * torch.eye(
        k_exp, dtype=gram.dtype, device=gram.device
    )


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
    reduce: Optional[Callable] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-site QP assembly: (gram, constraint rows, targets).

    The counterpart of the JAX package's ``_pallas_fit_parts``: the Gram of
    :func:`_site_gram` (``gram_fn``, ``tiled``) plus the l2 term, and the
    constraint system. ``cmap_rows``/``site_sel`` fit one site block (see
    :func:`_assemble_constraint_system`). ``reduce`` sums the Gram of this
    rank's frames over the ranks of a mesh (``FrameMesh.all_reduce``; the
    JAX package's ``_pallas_mesh_fit_parts``) before the l2 term.
    """
    rows_map = cmap_mat if cmap_rows is None else cmap_rows
    gram = _site_gram(
        coords, forces, mask, rows_map, group_mean, onehot, counts, centers,
        kbt, spec, gram_fn, tiled,
    )
    if reduce is not None:
        gram = reduce(gram)
    gram = _regularized(gram, l2_regularization)
    a_rows, b = _assemble_constraint_system(
        constr_coords, cmap_mat, group_mean, onehot, counts, centers, spec,
        cmap_rows=cmap_rows, site_sel=site_sel,
    )
    return gram, a_rows, b


def _fit_coefs(
    coords: torch.Tensor,  # (T, N, 3) float32 on the fit's device
    forces: torch.Tensor,
    mask: torch.Tensor,  # (T,)
    constr_coords: torch.Tensor,  # (F, N, 3) the constraint frames
    cmap_mat, group_mean, onehot, counts, centers, kbt, l2_regularization,
    spec: GBFeatSpec, solver_delta: float, solver_iters: int,
    gram_fn: Callable,
    tiled: bool = False,
    cmap_rows: Optional[torch.Tensor] = None,
    site_sel: Optional[torch.Tensor] = None,
    reduce: Optional[Callable] = None,
):
    """Whole fit of all sites, or of one site block: Gram/constraint
    assembly and the shared-factor KKT solve (the JAX package's
    ``_fit_coefs_e2e`` and ``_fit_coefs`` in one, with ``cmap_rows``/
    ``site_sel`` its ``_siteblock_fit_body`` and
    ``_fit_coefs_siteblock_e2e``, and with ``reduce`` the mesh fit of
    ``_pallas_mesh_fit_parts``, see :func:`_fit_parts`).

    Returns (coefs (Sb, K_exp), per-site residuals (Sb,), gram, a_rows, b),
    all on the device; the QP pieces are fetched only if the float64
    escalation needs them.
    """
    gram, a_rows, b = _fit_parts(
        coords, forces, mask, constr_coords, cmap_mat, group_mean, onehot,
        counts, centers, kbt, l2_regularization, spec, gram_fn, tiled,
        cmap_rows, site_sel, reduce,
    )
    coefs, resids = _solve_parts(gram, a_rows, b, solver_delta, solver_iters)
    return coefs, resids, gram, a_rows, b


def _solve_parts(
    gram: torch.Tensor,  # (S, K_exp, K_exp), l2 term included
    a_rows: torch.Tensor,  # (S, m, K_exp)
    b: torch.Tensor,  # (S, m)
    solver_delta: float = SOLVER_DELTA,
    solver_iters: int = SOLVER_ITERS,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One fit's KKT solve: (coefs (S, K_exp), per-site residuals (S,)).

    The same shared-factor solver the batch path uses (with a fit batch of
    one), so single, streamed and batched fits agree per problem.
    """
    coefs, resids = batched_eqp_solve_shared(
        gram, a_rows[None], b[None, ..., None], delta=solver_delta,
        iters=solver_iters, return_resid=True,
    )
    return coefs[0, ..., 0], resids[0]


@full_fp32()
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


@full_fp32()
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


@full_fp32()
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

    # frames per application on the CPU, and per upload of numpy frames
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
        device_consts: Optional[Tuple[torch.Tensor, ...]] = None,
    ) -> None:
        """Store fit artifacts on ``device`` (group structure from the one-hot).

        ``coefs`` may already be a tensor on the device (the fit's output),
        which skips its re-upload. ``device_consts``, the
        :func:`map_constants` of the same arrays on ``device``, skips the
        upload of the map's constants (the batch fits share one set).
        """
        dev = resolve_device(device, coefs)
        self.device = dev
        self._coefs = torch.as_tensor(coefs, dtype=torch.float32, device=dev)
        if device_consts is None:
            device_consts = map_constants(cmap_mat, onehot, centers, dev)
        (
            self._cmap_mat, self._onehot, self._counts, self._group_mean,
            self._centers,
        ) = device_consts
        self._kbt = float(kbt)
        self._spec = spec
        self._host_geometry = (onehot, centers)
        self._kernel_consts = None  # gb_apply's group lists and centers, made on first use

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

    def _apply(self, points: torch.Tensor, copoints: torch.Tensor) -> torch.Tensor:
        """Mapped forces of frames on the map's device: the kernel
        (:func:`~aggforce_torch.ops.gb_apply.gb_apply`) on the card, the
        plain :func:`_fused_apply` elsewhere."""
        if self.device.type != "cuda":
            return _fused_apply(
                points, copoints, self._coefs, self._cmap_mat, self._group_mean,
                self._onehot, self._counts, self._centers, self._kbt, self._spec,
            )
        if self._kernel_consts is None:
            onehot, centers = self._host_geometry
            self._kernel_consts = tuple(
                torch.as_tensor(x, device=self.device)
                for x in (*group_members(onehot), exact_centers(centers, self._spec))
            )
        offsets, atoms, centers64 = self._kernel_consts
        return gb_apply(
            points.contiguous(), copoints.contiguous(), self._coefs, self._cmap_mat,
            offsets, atoms, self._counts, centers64, self._kbt, self._spec,
        )

    @span("aggforce.apply")
    def __call__(self, points, copoints):
        """Fused application (type-preserving).

        Tensor inputs yield a tensor on the map's device: on the card all
        frames in one kernel launch, which holds nothing of size frames x
        sites x groups; on the CPU in chunks of ``_APPLY_CHUNK`` frames
        concatenated there, so long trajectories apply in bounded memory.
        Numpy inputs are mapped on the device chunk by chunk and come back
        as numpy, matching CLAMap semantics.
        """
        device_in = isinstance(points, torch.Tensor) or isinstance(
            copoints, torch.Tensor
        )
        t = points.shape[0]
        step = self._APPLY_CHUNK
        if device_in and self.device.type == "cuda":
            step = max(t, 1)
        outs = []
        for lo in range(0, t, step):
            hi = min(t, lo + step)
            mapped = self._apply(
                self._to_device(points[lo:hi]), self._to_device(copoints[lo:hi])
            )
            outs.append(mapped if device_in else mapped.cpu().numpy())
        if device_in:
            return outs[0] if len(outs) == 1 else torch.cat(outs, dim=0)
        return np.concatenate(outs, axis=0)


def map_constants(cmap_mat, onehot, centers, device: torch.device):
    """A :class:`FusedGBMap`'s constants on ``device``: (cmap, onehot,
    counts, group_mean, centers), float32, the group structure taken from
    the one-hot."""
    onehot = np.asarray(onehot, dtype=np.float32)
    counts = onehot.sum(axis=0)
    return tuple(
        torch.as_tensor(np.asarray(x), dtype=torch.float32, device=device)
        for x in (
            cmap_mat, onehot, counts, (onehot / np.maximum(counts, 1.0)).T,
            centers,
        )
    )


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


@span("aggforce.escalate")
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
    if not converged(resid_val, resid_tol, coefs_np):
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


def _fit_constants(
    coord_map: LinearMap,
    spec: GBFeatSpec,
    constraints: Optional[Constraints],
    dev: torch.device,
) -> dict:
    """The group factorization (``onehot``, ``group_mean``, ``counts``,
    ``centers``), the fit's ``device`` and the fit constants uploaded once
    to it (``consts``: cmap, group_mean, onehot, counts, centers)."""
    geom = group_factorization(
        coord_map, spec, constraints if constraints is not None else set()
    )
    return dict(
        geom,
        device=dev,
        consts=tuple(
            torch.as_tensor(x, dtype=torch.float32, device=dev)
            for x in (
                coord_map.standard_matrix, geom["group_mean"], geom["onehot"],
                geom["counts"], geom["centers"],
            )
        ),
    )


def _prepare_fused_setup(
    traj: Trajectory,
    coord_map: LinearMap,
    spec: GBFeatSpec,
    constraints: Optional[Constraints],
    device: DeviceLike,
    mesh: Optional[FrameMesh] = None,
) -> dict:
    """Shared fit setup, the JAX package's ``_prepare_fused_setup`` without
    its padding plan and Pallas policy (the kernels mask the ragged frame
    edge): :func:`_fit_constants`, the frame count ``t`` and the float32
    trajectory on the device with its frame mask (``trajectory``: coords,
    forces, mask).

    With ``mesh`` the fit runs on the mesh's device and ``trajectory`` is
    this rank's padded share of the frames (:func:`parallel.mesh.shard_frames`),
    the pad masked."""
    if mesh is not None:
        dev = mesh_device(mesh, device)
    else:
        dev = resolve_device(device, traj.coords, traj.forces)
    out = dict(_fit_constants(coord_map, spec, constraints, dev), t=len(traj))
    if mesh is not None:
        out["trajectory"] = shard_frames(mesh, [traj.coords, traj.forces])
    else:
        coords = torch.as_tensor(traj.coords, dtype=torch.float32, device=dev)
        forces = torch.as_tensor(traj.forces, dtype=torch.float32, device=dev)
        mask = torch.ones(coords.shape[0], dtype=torch.float32, device=dev)
        out["trajectory"] = (coords, forces, mask)
    return out


def _frames_at(x, frame_idx: np.ndarray, dev: torch.device) -> torch.Tensor:
    """Frames ``frame_idx`` of an array or tensor, float32 on ``dev`` (only
    those frames are copied)."""
    if isinstance(x, torch.Tensor):
        x = x[torch.as_tensor(frame_idx, device=x.device)]
    else:
        x = np.asarray(x[frame_idx])
    return torch.as_tensor(x, dtype=torch.float32, device=dev)


@span("aggforce.entry")
@full_fp32()
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
    solver_delta: float = SOLVER_DELTA,
    solver_iters: int = SOLVER_ITERS,
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

    With ``mesh`` (``parallel.make_mesh``, 1-D over "frames"; every rank
    calls with the whole trajectory) each rank uploads only its contiguous
    share of the frame axis, padded to a multiple of the mesh size with
    masked frames, runs the Gram on it (the kernel on the card), and one
    all-reduce sums the per-site Grams; the constraint frames are rank 0's
    draw, and the constraint system, the solve and its escalation run
    replicated, so every rank returns the same map. ``device`` must then be
    None or the mesh's device. On one rank the result is the single-device
    fit's, bit for bit.
    """
    fm = as_frame_mesh(mesh) if mesh is not None else None
    setup = _prepare_fused_setup(traj, coord_map, spec, constraints, device, fm)
    dev = setup["device"]
    gram_fn = _gram_function(use_kernel, dev, chunk_size)
    rng = constraint_rng if constraint_rng is not None else np.random.default_rng()
    # short trajectories: cannot sample more distinct constraint frames than
    # exist, so clamp (every frame then anchors the orthogonality rows)
    n_constraint_frames = min(n_constraint_frames, setup["t"])
    frame_idx = rng.choice(setup["t"], size=n_constraint_frames, replace=False)
    coords, forces, mask = setup["trajectory"]
    if fm is None:
        constr_coords = coords[torch.as_tensor(frame_idx, device=dev)]
    else:
        constr_coords = _frames_at(traj.coords, fm.broadcast_array(frame_idx), dev)
    coefs, resids, gram, a_rows, b = _fit_coefs(
        coords, forces, mask, constr_coords, *setup["consts"],
        float(kbt), float(l2_regularization), spec, solver_delta, solver_iters,
        gram_fn, reduce=None if fm is None else fm.all_reduce,
    )
    return _package_fused_map(
        coefs, torch.amax(resids), gram, a_rows, b, coord_map, setup["onehot"],
        setup["centers"], kbt, spec, resid_tol, dev,
    )


@span("aggforce.entry")
@full_fp32()
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
    solver_delta: float = SOLVER_DELTA,
    solver_iters: int = SOLVER_ITERS,
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
    checked and escalated), a depth-1 pipeline.

    Escalation is per site, by design: a site whose float32 solve is
    non-finite or misses ``resid_tol`` (NaN-aware) is re-solved by the
    float64 LAPACK oracle, and converged sites keep their device results.
    ``tags["solver_resid"]`` is the max residual over sites after
    escalation, ``tags["escalated"]`` the number of escalated sites and
    ``tags["escalation_seconds"]`` the host time their solves took.

    With ``mesh`` (``parallel.make_mesh``) the site blocks are split over
    the ranks: each step fits ``site_block * n_ranks`` sites, one block per
    rank (the tiled kernel on each rank's block), on the whole trajectory
    uploaded to every rank. The blocks are independent, so no collective
    runs until the end, where one all-gather gives every rank every site's
    coefficients (after its owner's per-site escalation), and every rank
    returns the same map. The constraint frames are rank 0's draw.
    """
    fm = as_frame_mesh(mesh) if mesh is not None else None
    setup = _prepare_fused_setup(
        traj, coord_map, spec, constraints,
        device if fm is None else mesh_device(fm, device),
    )
    dev = setup["device"]
    gram_fn = _gram_function(use_kernel, dev, chunk_size, tiled=True)
    onehot, centers = setup["onehot"], setup["centers"]
    rng = constraint_rng if constraint_rng is not None else np.random.default_rng()
    n_constraint_frames = min(n_constraint_frames, setup["t"])
    frame_idx = rng.choice(setup["t"], size=n_constraint_frames, replace=False)
    if fm is not None:
        frame_idx = fm.broadcast_array(frame_idx)

    def f32(x):
        return torch.as_tensor(x, dtype=torch.float32, device=dev)

    cmap_np = np.asarray(coord_map.standard_matrix, dtype=np.float32)
    s_all = cmap_np.shape[0]
    sb = max(1, min(site_block, s_all))
    n_rank, rank = (1, 0) if fm is None else (fm.size, fm.rank)
    step_sites = sb * n_rank  # sites per step: one block per rank
    coords, forces, mask = setup["trajectory"]
    constr_coords = coords[torch.as_tensor(frame_idx, device=dev)]
    common = (
        *setup["consts"], float(kbt), float(l2_regularization), spec,
        solver_delta, solver_iters, gram_fn,
    )
    # this rank's blocks, all sb rows each (padding included, so every
    # rank's stack has one shape): coefficients, residual, escalated flag
    rows_blocks = []
    escalation_s = 0.0

    def drain(entry) -> None:
        nonlocal escalation_s
        n_valid, coefs_b, resid_b, gram_b, rows_b, b_b = entry
        coefs_np = np.array(coefs_b.cpu())
        resid_np = np.array(resid_b.cpu())
        bad = ~converged(resid_np, resid_tol, coefs_np)
        bad[n_valid:] = False  # padding sites are dropped, never escalated
        if bad.any():
            t0 = time.perf_counter()
            sel = torch.as_tensor(np.nonzero(bad)[0], device=gram_b.device)
            coefs_np[bad], resid_np[bad] = _host_solve(gram_b[sel], rows_b[sel], b_b[sel])
            escalation_s += time.perf_counter() - t0
        rows_blocks.append(np.concatenate([coefs_np, resid_np[:, None], bad[:, None]], axis=1))

    pending = None
    for s0 in range(0, s_all, step_sites):
        # the step's sites, padded by repeating its last one; this rank's
        # block is its slice
        step = np.arange(s0, min(s0 + step_sites, s_all))
        pad_idx = np.concatenate([step, np.repeat(step[-1:], step_sites - len(step))])
        pad_idx = pad_idx[rank * sb : (rank + 1) * sb]
        sel = np.zeros((sb, s_all), dtype=np.float32)
        sel[np.arange(sb), pad_idx] = 1.0
        entry = (int(np.clip(len(step) - rank * sb, 0, sb)),) + _fit_coefs(
            coords, forces, mask, constr_coords, *common, tiled=True,
            cmap_rows=f32(cmap_np[pad_idx]), site_sel=f32(sel),
        )
        if pending is not None:
            drain(pending)
        pending = entry
        del entry
    if pending is not None:
        drain(pending)
    rows_all = np.concatenate(rows_blocks, axis=0)
    if fm is not None:
        # the one collective of the fit: every rank's blocks, put back in
        # site order (step, rank, site of the block)
        cols = rows_all.shape[-1]
        gathered = fm.all_gather(f32(rows_all)).cpu().numpy()
        rows_all = gathered.reshape(n_rank, -1, sb, cols).transpose(1, 0, 2, 3).reshape(-1, cols)
        escalation_s = float(
            fm.all_reduce(torch.tensor([escalation_s], dtype=torch.float64, device=dev))[0]
        )
    rows_all = rows_all[:s_all]
    coefs_all = np.ascontiguousarray(rows_all[:, :-2])
    if not np.all(np.isfinite(coefs_all)):
        raise ValueError("Map optimization failed.")
    return _wrap_fused_map(
        coefs_all, coord_map, onehot, centers, kbt, spec,
        {
            "coef_list": list(coefs_all),
            "solver_resid": float(rows_all[:, -2].max()),
            "escalated": int(rows_all[:, -1].sum()),
            "escalation_seconds": escalation_s,
        },
        dev,
    )


def _fit_coefs_batch(
    coords: torch.Tensor,  # (T, N, 3) float32 on the fit's device
    forces: torch.Tensor,
    mask: torch.Tensor,  # (T,)
    constr_src: torch.Tensor,  # (T', N, 3) the frames frame_idx_batch indexes
    frame_idx_batch: torch.Tensor,  # (B, F) constraint-frame indices per fit
    cmap_mat, group_mean, onehot, counts, centers, kbt, l2_regularization,
    spec: GBFeatSpec, solver_delta: float, solver_iters: int,
    gram_fn: Callable,
    mesh: Optional[FrameMesh] = None,
):
    """B fits over the same trajectory with different constraint samples,
    sharing one Gram (the JAX package's ``_fit_coefs_batch_e2e``, and with
    ``mesh`` its ``_fit_coefs_batch_mesh``).

    The Gram does not depend on which frames anchor the orthogonality
    constraints, so it is taken once (:func:`_site_gram`); the B constraint
    systems are assembled together, and one shared-factor solve factors each
    site once for every fit. The solve runs without host checks, so the
    whole window is enqueued without a host sync. With ``mesh`` the Gram is
    this rank's frames' summed over the ranks, and the solve is
    :func:`ops.eqp.batched_eqp_solve_shared_mesh` (sites, then fits, split
    over the ranks). Returns (:func:`_batch_fit_outputs`, gram), all on the
    device.
    """
    gram = _site_gram(
        coords, forces, mask, cmap_mat, group_mean, onehot, counts, centers,
        kbt, spec, gram_fn,
    )
    if mesh is not None:
        gram = mesh.all_reduce(gram)
    gram = _regularized(gram, l2_regularization)
    rows_b, b_b = _constraint_system(
        constr_src, frame_idx_batch, cmap_mat, group_mean, onehot, counts, centers,
        spec,
    )
    solve = (
        batched_eqp_solve_shared
        if mesh is None
        else partial(batched_eqp_solve_shared_mesh, mesh=mesh)
    )
    coefs_b, resid_fs = solve(
        gram, rows_b, b_b[..., None], delta=solver_delta, iters=solver_iters,
        return_resid=True, host_checks=False,
    )
    return _batch_fit_outputs(coefs_b[..., 0], resid_fs), gram


def _batch_fit_outputs(coefs_b: torch.Tensor, resid_fs: torch.Tensor):
    """(coefficients (B, S, K_exp), each fit's largest site residual (B,),
    each fit's finiteness (B,)), still on the device. The finiteness is
    checked on the device, so the host fetches two (B,) vectors per window
    instead of the coefficients; the (B, S, m, K_exp) constraint systems are
    not kept (an escalating fit recomputes its own,
    :func:`_constraint_system`)."""
    finite_b = torch.isfinite(coefs_b).all(dim=2).all(dim=1)
    return coefs_b, torch.amax(resid_fs, dim=1), finite_b


def _fetch_async(*tensors: torch.Tensor):
    """Start copying small device tensors to the host; returns (host
    tensors, wait), where ``wait()`` blocks until the copies (and the work
    enqueued before them) are done, and nothing enqueued after. CPU tensors
    are copied at once."""
    if tensors[0].device.type != "cuda":
        return [t.clone() for t in tensors], lambda: None
    host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in tensors]
    for h, t in zip(host, tensors):
        h.copy_(t, non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    return host, done.synchronize


class _LazyCoefTags(dict):
    """Tags dict whose ``coef_list`` materializes from the still-on-device
    coefficients on first read access.

    Most consumers of a batch of fits (bootstrap pipelines that apply the
    maps on the device) never read ``coef_list``, so the (S, K_exp) fetch of
    each fit is deferred until something asks for the host arrays.
    Read accessors (getitem/get/contains, iteration/len, keys/items/values,
    ==, copy, pop/setdefault, repr) materialize first; after that this is a
    plain dict holding numpy rows, as the eager ``coef_list`` tag of a
    single fit. Because ``keys``/``items``/``__iter__``/``__len__`` are all
    overridden, ``dict(tags)``, ``{**tags}`` and ``json.dumps(tags)``
    materialize too.
    """

    def __init__(self, coefs_dev: torch.Tensor, base: dict) -> None:
        super().__init__(base)
        self._coefs_dev = coefs_dev

    def _materialize(self) -> None:
        dev = self.__dict__.get("_coefs_dev")
        if dev is not None:
            self._coefs_dev = None
            super().__setitem__("coef_list", list(dev.cpu().numpy()))

    def __getitem__(self, key):
        if key == "coef_list":
            self._materialize()
        return super().__getitem__(key)

    def get(self, key, default=None):
        if key == "coef_list":
            self._materialize()
        return super().get(key, default)

    def __contains__(self, key) -> bool:
        if key == "coef_list":
            self._materialize()
        return super().__contains__(key)

    def __setitem__(self, key, value) -> None:
        if key == "coef_list":
            # a user-assigned value wins: cancel the pending fetch
            self._coefs_dev = None
        super().__setitem__(key, value)

    def pop(self, key, *default):
        if key == "coef_list":
            self._materialize()
        return super().pop(key, *default)

    def popitem(self):
        self._materialize()
        return super().popitem()

    def setdefault(self, key, default=None):
        if key == "coef_list":
            self._materialize()
        return super().setdefault(key, default)

    def __iter__(self):
        self._materialize()
        return super().__iter__()

    def __len__(self) -> int:
        self._materialize()
        return super().__len__()

    def keys(self):
        self._materialize()
        return super().keys()

    def items(self):
        self._materialize()
        return super().items()

    def values(self):
        self._materialize()
        return super().values()

    def copy(self):
        self._materialize()
        return dict(super().items())

    def __repr__(self) -> str:
        self._materialize()
        return super().__repr__()

    def __eq__(self, other) -> bool:
        self._materialize()
        return super().__eq__(other)

    def __ne__(self, other):
        # dict's C-level richcompare would otherwise bypass __eq__
        result = self.__eq__(other)
        if result is NotImplemented:
            return result
        return not result

    __hash__ = None  # mutable mapping, same as dict


def _window_indices(seeds, t: int, n_cf: int, window: int) -> np.ndarray:
    """(n_windows, B, n_cf) constraint-frame indices: seed s draws
    ``np.random.default_rng(s).choice(t, n_cf, replace=False)``, the frames
    of a single fit with ``constraint_rng=np.random.default_rng(s)``. A tail
    window is padded to ``window`` fits by repeating its last seed's draw
    (padded fits are discarded); a sole window shorter than ``window`` is
    not padded."""
    idx = [np.random.default_rng(seed).choice(t, size=n_cf, replace=False) for seed in seeds]
    if len(seeds) < window:
        return np.stack(idx)[None]
    n_tail = len(seeds) % window
    if n_tail:
        if window - n_tail > n_tail:
            warnings.warn(
                f"fused_gb_linear_map_batch: tail of {n_tail} seeds padded to "
                f"the {window}-fit window ({window - n_tail} discarded solves; "
                f"align len(seeds) to flush_every to avoid)",
                stacklevel=5,  # past the batch fit and its span and full_fp32 scopes
            )
        idx += [idx[-1]] * (window - n_tail)
    return np.stack(idx).reshape(-1, window, n_cf)


@span("aggforce.entry")
@full_fp32()
def fused_gb_linear_map_batch(
    traj: Trajectory,
    coord_map: LinearMap,
    kbt: float,
    spec: GBFeatSpec,
    seeds,
    constraints: Optional[Constraints] = None,
    n_constraint_frames: int = 20,
    l2_regularization: float = 1e1,
    chunk_size: int = 2048,
    solver_delta: float = SOLVER_DELTA,
    solver_iters: int = SOLVER_ITERS,
    resid_tol: float = 1e-4,
    use_kernel: Union[bool, str] = "auto",
    flush_every: int = 16,
    mesh=None,
    device: DeviceLike = None,
):
    """Fit one map per constraint-sample seed, one Gram per window of seeds.

    Every fit runs over the same trajectory, so the Gram is the same for
    every seed: each window of ``flush_every`` seeds takes it once and
    solves the window's fits in one shared-factor solve
    (:func:`_fit_coefs_batch`). Fit i of the result equals the single fit
    ``fused_gb_linear_map(..., constraint_rng=np.random.default_rng(seeds[i]))``.
    Uses: bootstrap uncertainty over the sampled orthogonality frames, or
    many maps fast. Returns a list of CLAFTMaps, one per seed, each
    convergence-checked as :func:`fused_gb_linear_map` is: a fit whose
    coefficients are not finite or whose residual misses ``resid_tol``
    (NaN-aware) is escalated alone to the float64 host oracle
    (``tags["escalated"]``). ``use_kernel`` and ``device`` are those of
    :func:`fused_gb_linear_map`.

    The whole window is enqueued without a host sync, and window w + 1 is
    enqueued before window w is packaged, so the host's packaging overlaps
    the device's next window. The host fetches two (B,) vectors per window
    (each fit's residual and finiteness); the coefficients stay on the
    device inside the maps, and ``tags["coef_list"]`` fetches them on first
    read (``_LazyCoefTags``). A tail window is padded to ``flush_every`` fits,
    with a warning when more than half of it is padding.

    With ``mesh`` each window's Gram is frame-sharded as in
    :func:`fused_gb_linear_map` (the kernel once per rank per window, one
    all-reduce), and the window's solve is split over the ranks (sites for
    the factorization, fits for the Schur stage); the constraint frames are
    rank 0's draws, so every rank returns the same maps.
    """
    seeds = list(seeds)
    if not seeds:
        return []
    fm = as_frame_mesh(mesh) if mesh is not None else None
    setup = _prepare_fused_setup(traj, coord_map, spec, constraints, device, fm)
    dev = setup["device"]
    gram_fn = _gram_function(use_kernel, dev, chunk_size)
    onehot, centers = setup["onehot"], setup["centers"]
    window = max(1, int(flush_every))
    n_cf = min(n_constraint_frames, setup["t"])
    # every window's indices in one upload, before any work is enqueued
    idx_np = _window_indices(seeds, setup["t"], n_cf, window)
    coords, forces, mask = setup["trajectory"]
    if fm is None:
        constr_src, idx_dev = coords, torch.as_tensor(idx_np, device=dev)
    else:
        # only the constraint frames of every window are uploaded
        idx_np = fm.broadcast_array(idx_np)
        constr_src = _frames_at(traj.coords, idx_np.reshape(-1), dev)
        idx_dev = torch.arange(idx_np.size, device=dev).reshape(idx_np.shape)
    consts = setup["consts"]
    # one set of map constants and one device coordinate map for every map
    cmap_np = np.asarray(coord_map.standard_matrix, dtype=np.float32)
    cmap_dev, gmean_dev, onehot_dev, counts_dev, centers_dev = consts
    map_consts = (cmap_dev, onehot_dev, counts_dev, gmean_dev, centers_dev)
    package_coord_map = (
        TLinearMap.from_linearmap(coord_map, device=dev)
        if isinstance(coord_map, LinearMap) and not isinstance(coord_map, TLinearMap)
        else coord_map
    )
    maps = []

    def dispatch(w: int):
        (coefs_b, resid_b, finite_b), gram = _fit_coefs_batch(
            coords, forces, mask, constr_src, idx_dev[w], *consts, float(kbt),
            float(l2_regularization), spec, solver_delta, solver_iters, gram_fn,
            fm,
        )
        n_valid = min(len(seeds) - w * window, idx_np.shape[1])
        return (w, n_valid, coefs_b, gram) + tuple(_fetch_async(resid_b, finite_b))

    def package(pending) -> None:
        w, n_valid, coefs_b, gram, (resid_h, finite_h), wait = pending
        wait()
        resid_np = resid_h.numpy()
        ok = converged(resid_np, resid_tol, finite=finite_h.numpy())
        gram_h = None  # the window's Gram on the host, fetched once if a fit escalates
        for i in range(n_valid):
            resid_i = float(resid_np[i])
            if ok[i]:
                force_map = FusedGBMap(
                    coefs=coefs_b[i], cmap_mat=cmap_np, onehot=onehot,
                    centers=centers, kbt=kbt, spec=spec,
                    tags=_LazyCoefTags(
                        coefs_b[i], {"solver_resid": resid_i, "escalated": False}
                    ),
                    device=dev, device_consts=map_consts,
                )
                maps.append(CLAFTMap(coord_map=package_coord_map, force_map=force_map))
                continue
            # escalation: recompute this fit's constraint system and take
            # the single fit's float64 packaging path
            rows, b = _constraint_system(
                constr_src, idx_dev[w, i], cmap_dev, gmean_dev, onehot_dev,
                counts_dev, centers_dev, spec,
            )
            if gram_h is None:
                gram_h = gram.cpu()
            maps.append(
                _package_fused_map(
                    coefs_b[i], resid_i, gram_h, rows, b, package_coord_map,
                    onehot, centers, kbt, spec, resid_tol, dev,
                )
            )

    pending = None
    for w in range(idx_np.shape[0]):
        entry = dispatch(w)
        if pending is not None:
            package(pending)
        pending = entry
        del entry
    if pending is not None:
        package(pending)
    return maps
