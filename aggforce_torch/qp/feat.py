r"""Gaussian distance-basis features (torch).

Counterpart of the JAX package's ``qp/jaxfeat.py``. Behavior parity target:
reference qp/jaxfeat.py:20-567 (``gb_feat``: each fg site featurized by
Gaussian bins of its distance to a cg site, constrained atoms smeared
together and sharing one-hot channels; divergences of the collapsed
features w.r.t. the fg coordinates with the cg points held fixed).

Divergences default to the closed form (``div_method="closed"``): for
s = smear(x), d_j = |s_j - c| and basis phi_k,

    div[t, (g,k), a] = sum_j phi_k'(d_tj) * u_tja * SC[j, g],
    u = (s - c)/d,   SC[j, g] = sum_{m: channel(m)=g} S[j, m]

The reference's autodiff methods are kept as cross-checks: "reorder"
(``torch.func.jacrev`` of the frame-collapsed basis values, channels
allocated after) and "basic" (``torch.func.jacfwd`` of the collapsed,
channelized features). Like the reference, both give NaN where a fine-grained
atom sits on its cg point (the derivative of |s - c| at 0).

The fused fit recognizes this module's :func:`gb_feat` by identity and
never calls it; it is the protocol featurizer for other consumers.
"""

from functools import partial
from typing import Final, Iterable, Tuple, Union

import numpy as np
import torch

from ..constraints import Constraints, reduce_constraint_sets
from ..map import LinearMap, smear_map
from ..ops.torchcore import abatch, distances, trjdot
from ..utils.device import DeviceLike, resolve_device
from .featlinearmap import Features, KNAME_DIVS, KNAME_FEATS, KNAME_NAMES, id_feat

DIVMETHOD_REORDER: Final = "reorder"
DIVMETHOD_BASIC: Final = "basic"
DIVMETHOD_CLOSED: Final = "closed"


def _centers(outer, inner, n_basis, dist_power, like: torch.Tensor) -> torch.Tensor:
    pow_grid = torch.linspace(
        inner**dist_power, outer**dist_power, n_basis,
        dtype=like.dtype, device=like.device,
    )
    return pow_grid ** (1.0 / dist_power)


def gaussian_dist_basis(
    dists: torch.Tensor,
    outer: float,
    inner: float = 0,
    n_basis: int = 10,
    width: float = 1.0,
    dist_power: float = 0.5,
    clip: float = 1e-3,
) -> torch.Tensor:
    """Expand distances in a grid of clipped Gaussians (appended axis).

    Grid points are uniform after the transform x -> x**dist_power
    (dist_power < 1 concentrates bins near ``inner``).
    """
    centers = _centers(outer, inner, n_basis, dist_power, dists)
    offset = (dists[..., None] - centers) / width
    gauss = torch.exp(-(offset**2))
    if clip is None:
        return gauss
    return torch.clamp(gauss, min=clip) - clip


def clipped_gauss(
    inp: torch.Tensor, center, width: float = 1.0, clip: float = 1e-3
) -> torch.Tensor:
    """Gaussian of (inp - center)/width, floored at ``clip`` then shifted to 0."""
    gauss = torch.exp(-(((inp - center) / width) ** 2))
    if clip is None:
        return gauss
    return torch.clamp(gauss, min=clip) - clip


def _channel_onehot(channels: Tuple[int, ...], n_channels: int, like) -> torch.Tensor:
    """(n_sites, n_channels) one-hot of each site's constraint-group channel."""
    idx = torch.as_tensor(channels, device=like.device)
    return torch.nn.functional.one_hot(idx, n_channels).to(like.dtype)


def channel_allocate(
    feats: torch.Tensor,
    channels: Tuple[int, ...],
    max_channels: int,
    jac_shape: bool = False,
) -> torch.Tensor:
    """Distribute per-site features into per-channel one-hot slots.

    (n_frames, n_sites, K) -> (n_frames, n_sites, K*C) with site j's
    features landing in slot block ``channel(j)``. ``jac_shape`` takes the
    (K, n_frames, n_sites, n_dim) jacobian layout instead, allocating along
    the derivative-site axis: -> (K*C, n_frames, n_sites, n_dim).
    """
    n_channels = max_channels + 1
    onehot = _channel_onehot(channels, n_channels, feats)
    if jac_shape:
        k, t, j, d = feats.shape
        out = torch.einsum("ktjd,jc->cktjd", feats, onehot)
        return out.reshape(n_channels * k, t, j, d)
    t, j, k = feats.shape
    out = torch.einsum("tjk,jc->tjck", feats, onehot)
    return out.reshape(t, j, n_channels * k)


def gb_subfeat(
    points: torch.Tensor,
    cg_points: torch.Tensor,
    channels: Tuple[int, ...],
    max_channels: int,
    smear_mat: Union[None, torch.Tensor],
    collapse: bool = False,
    channelize: bool = True,
    **kwargs,
) -> torch.Tensor:
    """Features for one cg site: smear -> distances -> basis -> channels.

    ``collapse`` sums over frames and sites (for the autodiff divergence
    methods); 2-D ``points`` get a dummy frame axis.
    """
    dummy_axis = points.ndim == 2
    if dummy_axis:
        points = points[None, ...]
    if smear_mat is not None:
        points = trjdot(points, smear_mat)
    dists = distances(xyz=points, cross_xyz=cg_points)
    gauss = gaussian_dist_basis(dists, **kwargs)[:, 0, :, :]
    out = channel_allocate(gauss, channels, max_channels) if channelize else gauss
    if collapse:
        return out.sum(dim=(0, 1))
    if dummy_axis:
        return out[0, ...]
    return out


def _gb_closed_div(
    points: torch.Tensor,
    cg_points: torch.Tensor,
    channels: Tuple[int, ...],
    max_channels: int,
    smear_mat: Union[None, torch.Tensor],
    outer: float,
    inner: float = 0,
    n_basis: int = 10,
    width: float = 1.0,
    dist_power: float = 0.5,
    clip: float = 1e-3,
) -> torch.Tensor:
    """Closed-form divergence of the channelized collapsed features.

    Returns (n_frames, n_basis*(max_channels+1), n_dim).
    """
    n_channels = max_channels + 1
    spoints = trjdot(points, smear_mat) if smear_mat is not None else points
    # displacement of each (smeared) fg site from the single cg site
    disp = spoints - cg_points  # (T, N, 3)
    d = torch.sqrt(torch.sum(disp * disp, dim=-1))  # (T, N)
    u = disp / torch.clamp(d, min=1e-30)[..., None]  # unit vectors (T, N, 3)
    centers = _centers(outer, inner, n_basis, dist_power, d)
    offset = (d[..., None] - centers) / width  # (T, N, K)
    gauss = torch.exp(-(offset**2))
    live = gauss > clip if clip is not None else torch.ones_like(gauss, dtype=torch.bool)
    dphi = torch.where(live, gauss * (-2.0 * offset / width), torch.zeros_like(gauss))
    onehot = _channel_onehot(channels, n_channels, points)
    site_to_channel = smear_mat @ onehot if smear_mat is not None else onehot
    # div[t, g, k, a] = sum_j dphi[t,j,k] * u[t,j,a] * SC[j,g]
    div = torch.einsum("tjk,tja,jg->tgka", dphi, u, site_to_channel)
    return div.reshape(div.shape[0], n_channels * n_basis, 3)


def gb_subfeat_jac(
    points: torch.Tensor,
    cg_points: torch.Tensor,
    channels: Tuple[int, ...],
    max_channels: int,
    smear_mat: Union[torch.Tensor, None] = None,
    method: str = DIVMETHOD_CLOSED,
    **kwargs,
) -> torch.Tensor:
    """Per-frame divergences of the collapsed features for one cg site,
    (n_frames, n_basis*(max_channels+1), n_dim).

    ``method`` selects "closed" (the analytic form, default), "reorder"
    (``torch.func.jacrev`` before channel allocation: one reverse pass per
    basis function) or "basic" (``torch.func.jacfwd`` of the fully
    channelized features: one forward pass per coordinate of ``points``, so
    callers batch over few frames). All agree where every atom is off its
    cg point; the autodiff methods are cross-checks of the analytic one.
    """
    if method == DIVMETHOD_CLOSED:
        return _gb_closed_div(
            points, cg_points, channels=channels, max_channels=max_channels,
            smear_mat=smear_mat, **kwargs,
        )
    if method == DIVMETHOD_BASIC:

        def to_jac(x: torch.Tensor) -> torch.Tensor:
            return gb_subfeat(
                x, cg_points=cg_points, channels=channels,
                max_channels=max_channels, smear_mat=smear_mat, collapse=True,
                **kwargs,
            )

        jac = torch.func.jacfwd(to_jac)(points)  # (K_exp, T, N, 3)
        return jac.sum(dim=2).transpose(0, 1)
    if method == DIVMETHOD_REORDER:

        def to_jac_flat(x: torch.Tensor) -> torch.Tensor:
            return gb_subfeat(
                x, cg_points=cg_points, channels=channels,
                max_channels=max_channels, smear_mat=smear_mat, collapse=True,
                channelize=False, **kwargs,
            )

        jac = torch.func.jacrev(to_jac_flat)(points)  # (K, T, N, 3)
        ch_jac = channel_allocate(jac, channels, max_channels, jac_shape=True)
        return ch_jac.sum(dim=2).transpose(0, 1)
    raise ValueError("Unknown method for jacobian calculation.")


def gb_feat(
    points: np.ndarray,
    cmap: LinearMap,
    constraints: Constraints,
    outer: float,
    inner: float = 0,
    n_basis: int = 10,
    width: float = 1.0,
    dist_power: float = 0.5,
    batch_size: Union[None, int] = None,
    lazy: bool = True,
    div_method: str = DIVMETHOD_CLOSED,
    device: DeviceLike = None,
) -> Features:
    """Gaussian-binned fg<->cg distance features for every cg site.

    Protocol-compatible featurizer: returns per-cg-site generators (or lists
    with ``lazy=False``) of numpy feature arrays
    (n_frames, n_fg_sites, n_basis*(max_channel+1)) and divergence arrays
    (n_frames, n_feats, 3), computed on ``device`` (default: the GPU) over
    frame batches of ``batch_size`` (all frames at once when None).
    Constrained atoms are smeared to their group mean and share channels, so
    their features (and hence mapping weights) coincide. ``div_method`` is
    the divergence of :func:`gb_subfeat_jac`.
    """
    dev = resolve_device(device, points)
    points_dev = torch.as_tensor(points, dtype=torch.float32, device=dev)
    cg_points_all = torch.as_tensor(
        cmap(points_dev.cpu().numpy()), dtype=torch.float32, device=dev
    )
    reduced_cons = reduce_constraint_sets(constraints)
    ids = tuple(int(i) for i in id_feat(points, cmap, constraints, return_ids=True))
    smearm = torch.as_tensor(
        smear_map(
            site_groups=reduced_cons,
            n_sites=cmap.n_fg_sites,
            return_mapping_matrix=True,
        ),
        dtype=torch.float32, device=dev,
    )
    f_kwargs = {
        "channels": ids,
        "max_channels": max(ids),
        "smear_mat": smearm,
        "inner": inner,
        "outer": outer,
        "width": width,
        "n_basis": n_basis,
        "dist_power": dist_power,
    }
    inds = torch.arange(len(points_dev), device=dev)

    def per_site(func, cg_site: int) -> np.ndarray:
        def sub(arg_inds):
            return func(
                points_dev[arg_inds],
                cg_points_all[arg_inds, cg_site : cg_site + 1, :],
                **f_kwargs,
            )

        return abatch(sub, inds, batch_size).cpu().numpy()

    def feater(cg_site: int) -> np.ndarray:
        return per_site(gb_subfeat, cg_site)

    def divver(cg_site: int) -> np.ndarray:
        return per_site(partial(gb_subfeat_jac, method=div_method), cg_site)

    if lazy:
        feats: Iterable = (feater(x) for x in range(cmap.n_cg_sites))
        divs: Iterable = (divver(x) for x in range(cmap.n_cg_sites))
    else:
        feats = [feater(x) for x in range(cmap.n_cg_sites)]
        divs = [divver(x) for x in range(cmap.n_cg_sites)]

    return {KNAME_FEATS: feats, KNAME_DIVS: divs, KNAME_NAMES: None}
