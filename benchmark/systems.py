"""The benchmark's own systems, trajectories and shape arithmetic.

Frozen here so that a later change to ``aggforce_torch`` cannot move the
yardstick:

* :func:`build_system` turns a configuration file's ``system`` block into
  base coordinates, bonded pairs, cg sites and constraint groups;
* :func:`make_pool` is a copy of ``aggforce_torch.utils.synth.
  synthesize_trajectory_device``: a trajectory with exactly rigid
  bonded pairs, a Boltzmann harmonic tether and zero-sum constraint forces,
  drawn on the device from one ``torch.Generator``, a block of frames per
  few large calls;
* :func:`shapes` gives the sizes the work arithmetic needs: N atoms, G
  groups (the constraint groups and the loose atoms), S cg sites, K_exp =
  G * (1 + n_basis) featurized columns, R reduced linear columns (= G).

Nothing here imports the program.
"""

from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np
import torch

# frames drawn per step of make_pool: its transient buffers stay ~1 GB at
# 1,500 atoms beside the two full outputs
POOL_BLOCK = 8192


@dataclass(frozen=True)
class System:
    """A configuration's molecular system, independent of any trajectory."""

    base: np.ndarray  # (N, 3) float64 reference geometry
    pairs: List[Tuple[int, int]]  # bonded (rigid) atom pairs
    sites: List[int]  # the atom of each cg site (a C-alpha-style slice map)
    groups: List[List[int]]  # constraint groups and loose atoms, sorted by min
    kbt: float
    motion_scale: float
    internal_force_scale: float
    noise_force_scale: float

    @property
    def n_atoms(self) -> int:
        return self.base.shape[0]

    def cmap_matrix(self) -> np.ndarray:
        """(S, N) coordinate-map matrix: row s picks atom ``sites[s]``."""
        mat = np.zeros((len(self.sites), self.n_atoms))
        mat[np.arange(len(self.sites)), self.sites] = 1.0
        return mat

    def group_of_atom(self) -> np.ndarray:
        """(N,) index of each atom's group in ``groups``."""
        out = np.empty(self.n_atoms, dtype=np.int64)
        for g, members in enumerate(self.groups):
            out[members] = g
        return out


def build_system(cfg: Dict) -> System:
    """The system of a configuration file's ``system`` block."""
    sys_cfg = cfg["system"]
    n_atoms = int(sys_cfg["n_atoms"])
    base = np.random.default_rng(int(sys_cfg["base_seed"])).normal(
        scale=float(sys_cfg["base_scale"]), size=(n_atoms, 3)
    )
    bp = sys_cfg["bonded_pairs"]
    pairs = [(i, i + 1) for i in range(int(bp["start"]), int(bp["stop"]), int(bp["step"]))]
    groups = _groups(n_atoms, pairs)
    return System(
        base=base,
        pairs=pairs,
        sites=list(range(0, n_atoms, int(sys_cfg["cg_stride"]))),
        groups=groups,
        kbt=float(sys_cfg["kbt"]),
        motion_scale=float(sys_cfg["motion_scale"]),
        internal_force_scale=float(sys_cfg["internal_force_scale"]),
        noise_force_scale=float(sys_cfg["noise_force_scale"]),
    )


def _groups(n_atoms: int, pairs) -> List[List[int]]:
    """Connected components of the bonded pairs (loose atoms alone), each
    sorted, ordered by their smallest atom."""
    parent = list(range(n_atoms))

    def find(a: int) -> int:
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    for a, b in pairs:
        ra, rb = find(a), find(b)
        if ra != rb:
            parent[max(ra, rb)] = min(ra, rb)
    comps: Dict[int, List[int]] = {}
    for a in range(n_atoms):
        comps.setdefault(find(a), []).append(a)
    return sorted(comps.values(), key=min)


def shapes(system: System, cfg: Dict) -> Dict[str, int]:
    """N, G, S, K_exp (featurized columns with the id block), R."""
    g = len(system.groups)
    n_basis = int(cfg.get("featurizer", {}).get("n_basis", 0))
    return {
        "N": system.n_atoms,
        "G": g,
        "S": len(system.sites),
        "K_exp": g * (1 + n_basis),
        "R": g,
    }


def make_pool(
    system: System, n_frames: int, seed: int, device: torch.device
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(coords, forces), each (n_frames, N, 3) float32 on ``device``, from
    ``seed``: the same seed gives the same trajectory on a given device.

    Each group moves rigidly (one displacement per group and frame, std
    ``motion_scale``); the tether force -(kbT / motion_scale^2) * disp is
    split evenly over a group's members; constrained atoms carry zero-sum
    intra-group forces of std ``internal_force_scale``; every atom carries
    independent noise of std ``noise_force_scale``.
    """
    n = system.n_atoms
    unit = torch.as_tensor(system.group_of_atom(), device=device)
    sizes = np.array([len(m) for m in system.groups], dtype=np.float32)
    f32 = dict(dtype=torch.float32, device=device)
    inv = torch.as_tensor(1.0 / sizes, **f32)[unit][None, :, None]
    cmask = (torch.as_tensor(sizes, **f32)[unit] > 1).to(torch.float32)[None, :, None]
    base = torch.as_tensor(system.base, **f32)[None]
    n_units = len(system.groups)
    k_spring = system.kbt / system.motion_scale**2
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    coords = torch.empty((n_frames, n, 3), **f32)
    forces = torch.empty((n_frames, n, 3), **f32)
    for start in range(0, n_frames, POOL_BLOCK):
        block = min(POOL_BLOCK, n_frames - start)
        disp = (
            system.motion_scale
            * torch.randn((block, n_units, 3), generator=gen, **f32)
        )[:, unit]
        raw = system.internal_force_scale * torch.randn(
            (block, n, 3), generator=gen, **f32
        ) * cmask
        gsum = raw.new_zeros((block, n_units, 3)).index_add_(1, unit, raw)
        internal = raw - gsum[:, unit] * inv
        noise = system.noise_force_scale * torch.randn(
            (block, n, 3), generator=gen, **f32
        )
        coords[start : start + block] = base + disp
        forces[start : start + block] = (-k_spring * inv) * disp + internal + noise
    return coords, forces
