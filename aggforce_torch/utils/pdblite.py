"""Minimal PDB reading utilities (a copy of the JAX package's ``utils/pdblite.py``).

The reference test-suite uses mdtraj only to (a) load a PDB topology and
(b) regex-match atom names to build a carbon-alpha configurational map
(reference tests/test_forces.py:100-129).  mdtraj is a heavy native dependency;
here we parse the two ATOM record fields we need directly.
"""

import re
from typing import List, NamedTuple, Optional

import numpy as np


class PDBAtom(NamedTuple):
    """One ATOM/HETATM record (the fields this package uses)."""

    index: int
    name: str
    element: str
    residue: str
    residue_index: int
    xyz: "np.ndarray"  # shape (3,), nanometers


def read_pdb_atoms(path: str) -> List[PDBAtom]:
    """Parse ATOM/HETATM records from a PDB file (first model only).

    Coordinates are converted from Angstrom (PDB convention) to nanometers
    (mdtraj/aggforce convention). Multi-model files (NMR ensembles) yield
    the topology of MODEL 1 — concatenating every model would multiply the
    atom count and silently corrupt index-based maps.
    """
    atoms: List[PDBAtom] = []
    with open(path) as fh:
        for line in fh:
            if line.startswith("ENDMDL"):
                break
            if not (line.startswith("ATOM") or line.startswith("HETATM")):
                continue
            name = line[12:16].strip()
            residue = line[17:20].strip()
            res_index = int(line[22:26])
            x = float(line[30:38])
            y = float(line[38:46])
            z = float(line[46:54])
            element = line[76:78].strip()
            if not element:
                # fall back on the first alphabetic character of the atom name
                m = re.search(r"[A-Za-z]", name)
                element = m.group(0) if m else ""
            atoms.append(
                PDBAtom(
                    index=len(atoms),
                    name=name,
                    element=element.upper(),
                    residue=residue,
                    residue_index=res_index,
                    xyz=np.array([x, y, z], dtype=np.float64) / 10.0,
                )
            )
    return atoms


def pdb_coordinates(path: str) -> np.ndarray:
    """Return an (n_atoms, 3) nm coordinate array for a PDB file."""
    atoms = read_pdb_atoms(path)
    return np.stack([a.xyz for a in atoms], axis=0)


def ca_map_from_pdb(path: str, pattern: str = r"^CA$") -> List[List[int]]:
    """Index lists selecting atoms whose *name* matches ``pattern``.

    Returns the list-of-lists format accepted by ``LinearMap`` (one singleton
    per matching atom), mirroring the Cα-slice construction in the reference
    tests (tests/test_forces.py:100-129, which regex the mdtraj atom string).
    """
    atoms = read_pdb_atoms(path)
    out: List[List[int]] = []
    for a in atoms:
        if re.search(pattern, a.name):
            out.append([a.index])
    return out


def guess_h_bond_groups(path: str, cutoff_nm: float = 0.13) -> List[frozenset]:
    """Guess constrained bonds: hydrogens bound to their nearest heavy atom.

    Typical MD engines constrain X-H bond lengths; this reproduces that set
    from a single PDB frame by pairing each hydrogen with its closest heavy
    atom within ``cutoff_nm``. Used to synthesize test fixtures.
    """
    atoms = read_pdb_atoms(path)
    xyz = np.stack([a.xyz for a in atoms])
    heavy = [a for a in atoms if a.element != "H"]
    out = []
    for a in atoms:
        if a.element != "H":
            continue
        dists = np.linalg.norm(xyz[[h.index for h in heavy]] - a.xyz, axis=1)
        j = int(np.argmin(dists))
        if dists[j] < cutoff_nm:
            out.append(frozenset((a.index, heavy[j].index)))
    return out


def find_atom_indices(path: str, pattern: str) -> List[int]:
    """Indices of atoms whose name matches ``pattern``."""
    return [a.index for a in read_pdb_atoms(path) if re.search(pattern, a.name)]


def n_atoms(path: str) -> int:
    """Number of ATOM/HETATM records."""
    return len(read_pdb_atoms(path))


def element_masses(path: str) -> Optional[np.ndarray]:
    """Crude per-atom masses (amu) from element symbols, for test fixtures."""
    table = {"H": 1.008, "C": 12.011, "N": 14.007, "O": 15.999, "S": 32.06}
    atoms = read_pdb_atoms(path)
    return np.array([table.get(a.element, 12.0) for a in atoms])
