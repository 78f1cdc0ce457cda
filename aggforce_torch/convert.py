"""Carry a map fitted by the JAX package into the port.

A fitted static linear map (a ``SeperableTMap`` of two linear maps, as
``qp_linear_map`` returns) is defined by its two standard matrices. A fitted
Gaussian map (an ``AugmentedTMap``, as ``joptgauss_map`` returns) is defined
by the standard matrices of its map over the augmented system, the noise
covariance, the premap or postmap matrix of its augmenter, and ``kbt``; a
staged one (``ComposedTMap([post, pre])``) by both stages' matrices. The
augmenter gets a new seed: a JAX key cannot carry over into a torch
generator. A JAX ``FusedGBMap`` (inside a ``CLAFTMap``) is defined by plain arrays: its
per-site coefficients (``tmap.force_map.tags["coef_list"]``), the coordinate
map's standard matrix, and the fit's group factorization (``onehot`` and
basis ``centers`` from ``group_factorization``), plus ``kbt`` and the
featurization spec. These functions rebuild the port's objects from those
arrays, so a map fitted in JAX applies here and gives the same mapped
forces.
"""

from typing import Mapping, Optional

import numpy as np

from .map import AugmentedTMap, CLAFTMap, ComposedTMap, SeperableTMap, TLinearMap
from .qp.fusedfeat import FusedGBMap, GBFeatSpec
from .trajectory import TCondNormal
from .utils.device import DeviceLike, resolve_device


def linear_map_from_numpy(
    standard_matrix: np.ndarray, device: DeviceLike = None
) -> TLinearMap:
    """A TLinearMap with the given (n_cg_sites, n_fg_sites) standard matrix."""
    # a copy: the matrix may be a read-only view of another package's array
    return TLinearMap(mapping=np.array(standard_matrix), device=device)


def separable_map_from_numpy(
    coord_mat: np.ndarray, force_mat: np.ndarray, device: DeviceLike = None
) -> SeperableTMap:
    """The port's SeperableTMap of two TLinearMaps from a fitted linear map's
    coordinate and force standard matrices (``tmap.coord_map.standard_matrix``
    and ``tmap.force_map.standard_matrix``)."""
    dev = resolve_device(device)
    return SeperableTMap(
        coord_map=linear_map_from_numpy(coord_mat, device=dev),
        force_map=linear_map_from_numpy(force_mat, device=dev),
    )


def gauss_map_from_numpy(
    coord_mat: np.ndarray,
    force_mat: np.ndarray,
    cov,
    kbt: float,
    premap_mat: Optional[np.ndarray] = None,
    postmap_mat: Optional[np.ndarray] = None,
    seed: Optional[int] = None,
    device: DeviceLike = None,
) -> AugmentedTMap:
    """The port's AugmentedTMap from a fitted Gaussian map's arrays.

    ``coord_mat`` and ``force_mat`` are the standard matrices of the map over
    the augmented system (``tmap.tmap.coord_map`` and ``tmap.tmap.force_map``);
    ``premap_mat`` is the coordinate map the augmenter noises
    (``joptgauss_map``'s ``coord_map``), ``postmap_mat`` the matrix its
    source_postmap applies (a staged map's second stage), None for identity.
    Both act as NaN-filling maps without the raise, as the builders make them.
    """
    dev = resolve_device(device)

    def aug_map(mat):
        return TLinearMap(mapping=np.array(mat), bypass_nan_check=True, device=dev)

    augmenter = TCondNormal(
        cov=cov,
        premap=None if premap_mat is None else aug_map(premap_mat).flat_call,
        source_postmap=None if postmap_mat is None else aug_map(postmap_mat),
        seed=seed,
        device=dev,
    )
    return AugmentedTMap(
        aug_tmap=separable_map_from_numpy(coord_mat, force_mat, device=dev),
        augmenter=augmenter,
        kbt=kbt,
    )


def staged_gauss_map_from_numpy(
    pre_coord_mat: np.ndarray,
    pre_force_mat: np.ndarray,
    post_coord_mat: np.ndarray,
    post_force_mat: np.ndarray,
    cov,
    kbt: float,
    seed: Optional[int] = None,
    device: DeviceLike = None,
) -> ComposedTMap:
    """The port's ComposedTMap([post, pre]) from a fitted staged Gaussian
    map's arrays: the premap's (``tmap[1]``) two standard matrices and the
    second stage's map over the noised system (``tmap[0].tmap``). The second
    stage's augmenter maps its source correction with
    ``pre_force_mat @ pre_coord_mat.T``, as the builders make it."""
    dev = resolve_device(device)
    pre_force_mat = np.asarray(pre_force_mat)
    pre_coord_mat = np.asarray(pre_coord_mat)
    post = gauss_map_from_numpy(
        post_coord_mat, post_force_mat, cov, kbt,
        postmap_mat=pre_force_mat @ pre_coord_mat.T, seed=seed, device=dev,
    )
    pre = separable_map_from_numpy(pre_coord_mat, pre_force_mat, device=dev)
    return ComposedTMap(submaps=[post, pre])


def fused_map_from_numpy(
    coefs,
    cmap_mat: np.ndarray,
    onehot: np.ndarray,
    centers: np.ndarray,
    kbt: float,
    spec_fields: Mapping,
    device: DeviceLike = None,
) -> CLAFTMap:
    """The port's CLAFTMap(TLinearMap, FusedGBMap) from a fitted map's arrays.

    ``coefs`` is the (S, K_exp) coefficient array (or the list of per-site
    rows in ``coef_list``); ``spec_fields`` holds the fields of the
    featurization spec (``dataclasses.asdict`` of the JAX ``GBFeatSpec``).
    """
    dev = resolve_device(device)
    cmap_mat = np.asarray(cmap_mat)
    force_map = FusedGBMap(
        coefs=np.stack([np.asarray(c, dtype=np.float32) for c in coefs]),
        cmap_mat=cmap_mat.astype(np.float32),
        onehot=onehot,
        centers=centers,
        kbt=kbt,
        spec=GBFeatSpec(**dict(spec_fields)),
        device=dev,
    )
    return CLAFTMap(
        coord_map=linear_map_from_numpy(cmap_mat, device=dev), force_map=force_map
    )
