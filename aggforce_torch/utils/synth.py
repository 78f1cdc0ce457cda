"""Synthetic molecular-trajectory fixtures (numpy, seeded).

A copy of ``synthesize_trajectory`` from the JAX package's ``utils/synth.py``
so both packages build the same trajectories from the same seed. The
fixtures have:

  * exact holonomic pair constraints (constrained groups move rigidly, so
    their pairwise distances are constant);
  * large zero-sum intra-group forces (the physics that makes optimal force
    maps aggregate constrained partners);
  * a coordinate-dependent force component (harmonic tether) so featurized /
    configuration-dependent maps have recoverable signal;
  * per-atom thermal noise.
"""

from typing import List, Tuple

import numpy as np

from ..constraints.tools import reduce_constraint_sets


def synthesize_trajectory(
    base_coords: np.ndarray,
    constraint_groups: List[frozenset],
    n_frames: int,
    seed: int = 0,
    motion_scale: float = 0.02,
    internal_force_scale: float = 60.0,
    kbt: float = 0.6955215,
    noise_force_scale: float = 1.5,
    dtype=np.float32,
) -> Tuple[np.ndarray, np.ndarray]:
    """Build (coords, forces) with exact group constraints and Boltzmann forces.

    The ensemble is exactly Boltzmann-consistent at temperature ``kbt`` for a
    harmonic tether potential: displacements are Gaussian with std
    ``motion_scale`` and the conservative force is -(kbt/motion_scale^2) *
    displacement, so statistical identities that rely on the equilibrium
    density (e.g. the divergence correction of featurized maps, MSCG
    projections) hold on this data. Constraint groups translate rigidly (one
    shared displacement; tether force split evenly across members), keeping
    intra-group distances exactly constant. The additional zero-sum
    intra-group forces model constraint (Lagrange-multiplier) forces, which
    do not alter the configurational ensemble; the small per-atom noise force
    is mean-zero and configuration-independent.

    Arguments:
    ---------
    base_coords:
        (n_sites, 3) reference geometry (e.g. from a PDB).
    constraint_groups:
        Disjoint site groups that move rigidly.
    n_frames:
        Number of frames to generate.
    seed:
        RNG seed (fully deterministic output).
    motion_scale:
        Std-dev (nm) of per-frame displacements.
    internal_force_scale:
        Std-dev of the zero-sum intra-group (constraint) force component;
        dominating this makes constraint-aware aggregation strongly optimal.
    kbt:
        Temperature (in force*length units) of the synthetic ensemble; sets
        the tether stiffness kbt/motion_scale^2.
    noise_force_scale:
        Std-dev of independent per-atom force noise.

    Returns:
    -------
    coords, forces arrays of shape (n_frames, n_sites, 3).
    """
    rng = np.random.default_rng(seed)
    n_sites = base_coords.shape[0]
    groups = [sorted(g) for g in reduce_constraint_sets(set(constraint_groups))]
    grouped = set()
    for g in groups:
        grouped.update(g)
    loose = sorted(set(range(n_sites)) - grouped)

    # vectorized construction: label every site with a "unit" index (its
    # group, or itself if loose), draw one displacement per unit per frame,
    # and gather — no per-group python loop over the frame arrays.
    n_units = len(groups) + len(loose)
    unit_of_site = np.empty(n_sites, dtype=np.int64)
    inv_size = np.empty(n_sites, dtype=dtype)
    constrained_mask = np.zeros(n_sites, dtype=bool)
    for u, g in enumerate(groups):
        unit_of_site[g] = u
        inv_size[g] = 1.0 / len(g)
        constrained_mask[g] = True
    for u, site in enumerate(loose, start=len(groups)):
        unit_of_site[site] = u
        inv_size[site] = 1.0

    k_spring = dtype(kbt / motion_scale**2)
    unit_disp = motion_scale * rng.standard_normal(
        (n_frames, n_units, 3), dtype=dtype
    )
    disp = unit_disp[:, unit_of_site, :]
    tether = (-k_spring * inv_size[None, :, None]) * disp

    coords = base_coords[None, :, :].astype(dtype) + disp

    forces = tether + noise_force_scale * rng.standard_normal(
        (n_frames, n_sites, 3), dtype=dtype
    )
    # zero-sum intra-group (constraint) forces: draw per-site noise, subtract
    # the group mean via the unit gather
    raw = internal_force_scale * rng.standard_normal(
        (n_frames, n_sites, 3), dtype=dtype
    )
    raw[:, ~constrained_mask, :] = 0.0
    # group sums via contiguous-run reduction: sites sorted by unit form
    # contiguous segments, so reduceat computes all sums vectorized
    order = np.argsort(unit_of_site, kind="stable")
    seg_starts = np.searchsorted(unit_of_site[order], np.arange(n_units))
    group_sum = np.add.reduceat(raw[:, order, :], seg_starts, axis=1)
    forces += raw - group_sum[:, unit_of_site, :] * inv_size[None, :, None]
    return coords, forces
