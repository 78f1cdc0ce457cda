"""Synthetic molecular-trajectory fixtures (seeded).

``synthesize_trajectory``, ``synthesize_protein_fixture``,
``synthesize_dimer_fixture`` and ``reference_waterdimer`` are copies of the
JAX package's ``utils/synth.py`` (numpy), so both packages build the same
trajectories from the same seed. ``example_system`` picks the system of the
example scripts: a PDB's CLN025-style fixture, or the JAX bench's
standalone system. ``synthesize_trajectory_device`` builds the same kind of
trajectory on the torch device, with a torch generator: its random stream
differs from numpy's. The fixtures have:

  * exact holonomic pair constraints (constrained groups move rigidly, so
    their pairwise distances are constant);
  * large zero-sum intra-group forces (the physics that makes optimal force
    maps aggregate constrained partners);
  * a coordinate-dependent force component (harmonic tether) so featurized /
    configuration-dependent maps have recoverable signal;
  * per-atom thermal noise.
"""

import os
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..constraints.tools import reduce_constraint_sets
from .device import DeviceLike, resolve_device
from .pdblite import guess_h_bond_groups, pdb_coordinates

# the upstream water-dimer fixture, where the reference's test data sits in
# a checkout of this repository (absent until it is added)
WATERDIMER = str(Path(__file__).resolve().parents[2] / "tests" / "data" / "waterdimer.npz")
# frames built per step of synthesize_trajectory_device: its transient
# buffers stay ~1 GB at 3,000 atoms beside the two full outputs
DEVICE_BLOCK = 8192


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


def _units(n_sites: int, constraint_groups):
    """Unit (rigid group, or loose site) of each site, 1/group size, and a
    0/1 mask of the constrained sites."""
    groups = [sorted(g) for g in reduce_constraint_sets(set(constraint_groups))]
    grouped = set()
    for g in groups:
        grouped.update(g)
    loose = sorted(set(range(n_sites)) - grouped)
    unit_of_site = np.empty(n_sites, dtype=np.int64)
    inv_size = np.empty(n_sites, dtype=np.float32)
    constrained = np.zeros(n_sites, dtype=np.float32)
    for u, g in enumerate(groups):
        unit_of_site[g] = u
        inv_size[g] = 1.0 / len(g)
        constrained[g] = 1.0
    for u, site in enumerate(loose, start=len(groups)):
        unit_of_site[site] = u
        inv_size[site] = 1.0
    return unit_of_site, len(groups) + len(loose), inv_size, constrained


def synthesize_trajectory_device(
    base_coords: np.ndarray,
    constraint_groups: List[frozenset],
    n_frames: int,
    seed: int = 0,
    motion_scale: float = 0.02,
    internal_force_scale: float = 60.0,
    kbt: float = 0.6955215,
    noise_force_scale: float = 1.5,
    device: DeviceLike = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Device-resident twin of :func:`synthesize_trajectory` (float32 tensors).

    Same construction (exact rigid groups, Boltzmann tether, zero-sum
    constraint forces) with a ``torch.Generator`` seeded on the device and
    on-device gathers, built in blocks of at most ``DEVICE_BLOCK`` frames
    written into the two (n_frames, n_sites, 3) outputs — for the
    100k-frame sweep, where host generation and the upload would dominate.
    The random stream differs from the numpy twin's; the output is
    deterministic per seed on a given device. ``device`` defaults to the
    GPU.
    """
    dev = resolve_device(device)
    n_sites = base_coords.shape[0]
    unit_np, n_units, inv_np, cmask_np = _units(n_sites, constraint_groups)
    f32 = dict(dtype=torch.float32, device=dev)
    uos = torch.as_tensor(unit_np, device=dev)
    inv = torch.as_tensor(inv_np, **f32)[None, :, None]
    cmask = torch.as_tensor(cmask_np, **f32)[None, :, None]
    base = torch.as_tensor(np.asarray(base_coords), **f32)[None]
    k_spring = kbt / motion_scale**2
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    coords = torch.empty((n_frames, n_sites, 3), **f32)
    forces = torch.empty((n_frames, n_sites, 3), **f32)
    for start in range(0, n_frames, DEVICE_BLOCK):
        block = min(DEVICE_BLOCK, n_frames - start)
        unit_disp = motion_scale * torch.randn(
            (block, n_units, 3), generator=gen, **f32
        )
        disp = unit_disp[:, uos]
        raw = internal_force_scale * torch.randn(
            (block, n_sites, 3), generator=gen, **f32
        ) * cmask
        # zero-sum intra-group (constraint) forces: subtract each group's
        # mean, summed by unit
        gsum = raw.new_zeros((block, n_units, 3)).index_add_(1, uos, raw)
        internal = raw - gsum[:, uos] * inv
        noise = noise_force_scale * torch.randn(
            (block, n_sites, 3), generator=gen, **f32
        )
        coords[start : start + block] = base + disp
        forces[start : start + block] = (-k_spring * inv) * disp + internal + noise
    return coords, forces


def synthesize_protein_fixture(
    pdb_path: str,
    n_frames: int,
    seed: int = 0,
    **kwargs,
) -> Dict[str, np.ndarray]:
    """CLN025-style fixture from a PDB: coords, forces, kbt, constraints."""
    base = pdb_coordinates(pdb_path)
    groups = guess_h_bond_groups(pdb_path)
    coords, forces = synthesize_trajectory(
        base, groups, n_frames=n_frames, seed=seed, **kwargs
    )
    return {
        "coords": coords,
        "forces": forces,
        "kbt": np.float64(0.6955215),  # 350 K in kcal/mol, reference convention
        "constraint_groups": groups,
    }


def synthesize_dimer_fixture(
    n_frames: int = 500, seed: int = 7
) -> Dict[str, np.ndarray]:
    """Flexible two-molecule fixture (no constraints).

    Intramolecular forces are large and zero-sum per molecule, so the optimal
    force map for an oxygen-slice coordinate map aggregates whole molecules —
    the same qualitative structure as the reference's water-dimer fixture.
    """
    rng = np.random.default_rng(seed)
    base = np.array(
        [
            [0.0, 0.0, 0.0],
            [0.096, 0.0, 0.0],
            [-0.024, 0.093, 0.0],
            [0.30, 0.0, 0.0],
            [0.396, 0.0, 0.0],
            [0.276, 0.093, 0.0],
        ]
    )
    coords = base[None] + rng.normal(scale=0.01, size=(n_frames, 6, 3))
    forces = rng.normal(scale=0.5, size=(n_frames, 6, 3))
    for mol in ([0, 1, 2], [3, 4, 5]):
        internal = rng.normal(scale=80.0, size=(n_frames, 3, 3))
        internal -= internal.mean(axis=1, keepdims=True)
        forces[:, mol, :] += internal
    return {
        "coords": coords.astype(np.float32),
        "forces": forces.astype(np.float32),
    }


def reference_waterdimer(path: str = WATERDIMER) -> Optional[Dict[str, np.ndarray]]:
    """Load the upstream water-dimer data fixture if present (else None)."""
    if not os.path.exists(path):
        return None
    data = np.load(path)
    return {"coords": data["coords"], "forces": data["Fs"]}


def standalone_fixture(n_frames: int, seed: int = 2024) -> Dict[str, np.ndarray]:
    """The JAX bench's standalone system (bench.py:290-307): 175 atoms
    (base coordinates from ``default_rng(0)``), 30 constraint pairs, a cg
    site on every 18th atom, kbT 0.6955215; the trajectory from ``seed``.
    Returns the keys of :func:`synthesize_protein_fixture` plus
    ``cg_sites``, the atoms of each cg site."""
    n_atoms = 175
    base = np.random.default_rng(0).normal(scale=0.5, size=(n_atoms, 3))
    groups = [frozenset((i, i + 1)) for i in range(0, 60, 2)]
    coords, forces = synthesize_trajectory(base, groups, n_frames, seed=seed)
    return {
        "coords": coords,
        "forces": forces,
        "kbt": np.float64(0.6955215),
        "constraint_groups": groups,
        "cg_sites": [[i] for i in range(0, n_atoms, 18)],
    }


def example_system(n_frames: int, seed: int, pdb: Optional[str] = None):
    """(fixture, LinearMap, label) of the example scripts' system.

    With ``pdb`` the CLN025-style fixture of that topology and its C-alpha
    map (the JAX examples' system); without it :func:`standalone_fixture`.
    Both trajectories come from ``seed``. A ``pdb`` that names no file
    raises FileNotFoundError.
    """
    from ..map import LinearMap
    from .pdblite import ca_map_from_pdb, n_atoms

    if pdb is None:
        fix = standalone_fixture(n_frames, seed=seed)
        cmap = LinearMap(fix["cg_sites"], n_fg_sites=fix["coords"].shape[1])
        return fix, cmap, "standalone (bench.py:290-307)"
    if not os.path.exists(pdb):
        raise FileNotFoundError(f"missing topology fixture: {pdb}")
    fix = synthesize_protein_fixture(pdb, n_frames=n_frames, seed=seed)
    return fix, LinearMap(ca_map_from_pdb(pdb), n_fg_sites=n_atoms(pdb)), f"pdb {pdb}"
