"""Carry a map fitted by the JAX package into the port.

A fitted static linear map (a ``SeperableTMap`` of two linear maps, as
``qp_linear_map`` returns) is defined by its two standard matrices. A JAX ``FusedGBMap`` (inside a ``CLAFTMap``) is defined by plain arrays: its
per-site coefficients (``tmap.force_map.tags["coef_list"]``), the coordinate
map's standard matrix, and the fit's group factorization (``onehot`` and
basis ``centers`` from ``group_factorization``), plus ``kbt`` and the
featurization spec. These functions rebuild the port's objects from those
arrays, so a map fitted in JAX applies here and gives the same mapped
forces.
"""

from typing import Mapping

import numpy as np

from .map import CLAFTMap, SeperableTMap, TLinearMap
from .qp.fusedfeat import FusedGBMap, GBFeatSpec
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
