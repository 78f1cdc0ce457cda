r"""Plain reference of the static linear force map (``qp_linear_map``).

Atoms of one constraint group share one coefficient, so with Fg[t, g] the
summed force of group g the map of cg site s is a vector x_s over the R
groups, minimizing sum_{t,a} (Fg[t, :, a] . x_s)^2 (+ l2 * sum_g count_g
x_s[g]^2) subject to sum_g A[c, g] x_s[g] = [c == s] for every cg site c,
A[c, g] the coordinate-map weight of site c on group g's atoms. The
per-atom map is W[s, j] = x_s[group of j]; mapped forces are W F.
"""

from typing import Dict, Optional

import numpy as np
import torch

from .numerics import dtype_of, eq_lstsq, full_precision, mm

# frames per block of the reference Gram: 3 * 8,192 rows x 1,125 columns in
# float64 is 221 MB
FRAME_BLOCK = 8192


def groups_from_pairs(n_atoms: int, pairs) -> np.ndarray:
    """(N,) group label of each atom: connected components of ``pairs``
    (loose atoms alone), numbered by their smallest atom."""
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
    roots = [find(a) for a in range(n_atoms)]
    order = {r: i for i, r in enumerate(sorted(set(roots)))}
    return np.array([order[r] for r in roots], dtype=np.int64)


def solve_map(
    forces: torch.Tensor,  # (T, N, 3)
    cmap: np.ndarray,  # (S, N)
    labels: np.ndarray,  # (N,) group of each atom
    l2: float,
    precision: str,
) -> torch.Tensor:
    """(S, N) force map, fitted in ``precision``."""
    dev, dt = forces.device, dtype_of(precision)
    lab = torch.as_tensor(labels, device=dev)
    r = int(labels.max()) + 1
    gram = torch.zeros((r, r), dtype=dt, device=dev)
    for lo in range(0, forces.shape[0], FRAME_BLOCK):
        block = forces[lo : lo + FRAME_BLOCK].to(dt)
        fg = block.new_zeros((block.shape[0], r, 3)).index_add_(1, lab, block)
        rows = fg.transpose(1, 2).reshape(-1, r)
        gram += mm(rows.T, rows, precision)
    counts = torch.bincount(lab, minlength=r).to(dt)
    p = gram + l2 * torch.diag(counts)
    cm = torch.as_tensor(cmap, dtype=dt, device=dev)
    a = cm.new_zeros((cm.shape[0], r)).index_add_(1, lab, cm)
    x = eq_lstsq(p, a, torch.eye(cm.shape[0], dtype=dt, device=dev), precision)
    return x[lab].T.contiguous()


def apply_map(w: torch.Tensor, forces: torch.Tensor, precision: str) -> torch.Tensor:
    """(T, S, 3) mapped forces W F in ``precision``."""
    dt = dtype_of(precision)
    t, n, _ = forces.shape
    flat = forces.to(dt).transpose(0, 1).reshape(n, -1)
    return mm(w.to(dt), flat, precision).reshape(w.shape[0], t, 3).transpose(0, 1)


def check_fit(
    forces: torch.Tensor,  # (T, N, 3) float32, the fit's frames
    cmap: np.ndarray,
    pairs,
    l2: float,
    fmap: Optional[np.ndarray],  # (S, N) the judged force map
    mapped: Optional[torch.Tensor],  # (T, S, 3) the judged mapped forces
    precision: str = "float64",
) -> Dict[str, float]:
    """Judge one linear fit.

    With ``fmap``/``mapped`` the program's outputs are judged; with
    ``fmap=None`` the map is fitted and applied here in ``precision`` (the
    control with ``"tf32"``). Returns ``force_rel_rms`` (root mean square of
    the mapped forces' difference from the float64 optimum's, over the
    optimum's), ``orth_viol`` (largest entry of M W^T - I) and ``apply_err``
    (largest error of the mapped forces against W F in float64, over the
    root mean square of W F).
    """
    labels = groups_from_pairs(cmap.shape[1], pairs)
    with full_precision():
        w_ref = solve_map(forces, cmap, labels, l2, "float64")
        if fmap is None:
            w_low = solve_map(forces, cmap, labels, l2, precision)
            w = w_low.double()
            mapped = apply_map(w_low, forces, precision)
        else:
            w = torch.as_tensor(fmap, dtype=torch.float64, device=forces.device)
        num = den = sq = 0.0
        worst = 0.0
        for lo in range(0, forces.shape[0], FRAME_BLOCK):
            block = forces[lo : lo + FRAME_BLOCK]
            best = apply_map(w_ref, block, "float64")
            exact = apply_map(w, block, "float64")
            judged = mapped[lo : lo + FRAME_BLOCK].double()
            num += float(torch.sum((judged - best) ** 2))
            den += float(torch.sum(best * best))
            sq += float(torch.sum(exact * exact))
            worst = max(worst, float(torch.max(torch.abs(judged - exact))))
        cm = torch.as_tensor(cmap, dtype=torch.float64, device=forces.device)
        orth = cm @ w.T - torch.eye(cm.shape[0], dtype=torch.float64, device=forces.device)
        return {
            "force_rel_rms": float(np.sqrt(num / den)),
            "orth_viol": float(torch.max(torch.abs(orth))),
            "apply_err": worst / float(np.sqrt(sq / mapped.numel())),
        }

