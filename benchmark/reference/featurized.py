r"""Plain reference of the featurized (id_feat + gb_feat) force-map fit.

For cg site s the fit minimizes x^T (X_s^T X_s + l2 I) x subject to the
sampled orthogonality rows A_s x = b_s. With the trajectory's groups g
(constraint groups and loose atoms, ordered by their smallest atom),
Fg[t, g] the summed force of group g's atoms, d[t, s, g] the distance from
group g's mean position to site s and u its unit vector, one row of X_s per
frame t and component a, over the columns [id: g | basis: (g, k)] (g-major):

    id      Fg[t, g, a]
    basis   Fg[t, g, a] * gz_k(d) + kbT * count_g * dphi_k(d) * u[a]

gz_k(d) = max(exp(-o^2), clip) - clip with o = (d - c_k) / width, and
dphi_k(d) = -2 o / width * exp(-o^2) where exp(-o^2) > clip, else 0;
c_k are ``n_basis`` centers evenly spaced in d^dist_power from inner to
outer. A constraint frame f gives one row per cg site c, nonzero only on
c's group g_c: [id: 1 | basis: gz_k(d[f, s, g_c])], with target 1 where
c = s and 0 elsewhere. The mapped force of site s on frame t is X_s[t] x.

This is the program's documented coefficient layout (``tags["coef_list"]``:
the id block, then basis k of group g at G + g * n_basis + k), which the
checks read to judge the program's coefficients.
"""

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .numerics import dtype_of, eq_lstsq, full_precision, max_violation, mm

# frames per block of design rows: 3 * 2,048 rows x 9,000 columns in float64
# is 442 MB
FRAME_BLOCK = 2048


class FeatSystem:
    """Topology arrays of one configuration on one device and dtype."""

    def __init__(self, system, cfg: Dict, device: torch.device, dtype: torch.dtype):
        spec = cfg["featurizer"]
        n, g = system.n_atoms, len(system.groups)
        onehot = torch.zeros((n, g), dtype=dtype, device=device)
        for gi, members in enumerate(system.groups):
            onehot[members, gi] = 1.0
        self.onehot = onehot
        self.counts = onehot.sum(dim=0)
        self.group_mean = (onehot / self.counts).T.contiguous()  # (G, N)
        self.cmap = torch.as_tensor(system.cmap_matrix(), dtype=dtype, device=device)
        self.site_groups = torch.as_tensor(
            system.group_of_atom()[system.sites], device=device
        )
        pw = float(spec["dist_power"])
        grid = np.linspace(float(spec["inner"]) ** pw, float(spec["outer"]) ** pw, int(spec["n_basis"]))
        self.centers = torch.as_tensor(grid ** (1.0 / pw), dtype=dtype, device=device)
        self.width = float(spec["width"])
        self.clip = float(spec["clip"])
        self.n_basis = int(spec["n_basis"])
        self.kbt = float(system.kbt)
        self.l2 = float(cfg["l2_regularization"])
        self.g = g
        self.k_exp = g * (1 + self.n_basis)


def _basis(fs: FeatSystem, coords: torch.Tensor, site: int, precision: str):
    """Group positions' basis values gz (t, G, K), scaled derivatives dphi
    (t, G, K) and unit vectors u (t, G, 3) for one site."""
    t = coords.shape[0]
    gpos = mm(fs.group_mean, coords.transpose(0, 1).reshape(coords.shape[1], -1), precision)
    gpos = gpos.reshape(fs.g, t, 3).transpose(0, 1)  # (t, G, 3)
    site_pos = mm(fs.cmap[site : site + 1], coords.transpose(0, 1).reshape(coords.shape[1], -1), precision)
    disp = gpos - site_pos.reshape(t, 1, 3)
    d = torch.sqrt(torch.sum(disp * disp, dim=-1))
    u = disp / torch.clamp(d, min=1e-30)[..., None]
    off = (d[..., None] - fs.centers) / fs.width
    raw = torch.exp(-(off * off))
    gz = torch.clamp(raw, min=fs.clip) - fs.clip
    dphi = torch.where(raw > fs.clip, raw * (-2.0 * off / fs.width), torch.zeros_like(raw))
    return gz, dphi, u


def design_rows(fs: FeatSystem, coords, forces, site: int, precision: str) -> torch.Tensor:
    """X_s of a block of frames: (t, 3, K_exp)."""
    t, n, _ = coords.shape
    gz, dphi, u = _basis(fs, coords, site, precision)
    fg = mm(fs.onehot.T, forces.transpose(0, 1).reshape(n, -1), precision)
    fg = fg.reshape(fs.g, t, 3).permute(1, 2, 0)  # (t, 3, G)
    div = (fs.kbt * fs.counts)[None, :, None, None] * dphi[..., None] * u[:, :, None, :]
    basis = fg[..., None] * gz[:, None] + div.permute(0, 3, 1, 2)  # (t, 3, G, K)
    return torch.cat([fg, basis.reshape(t, 3, -1)], dim=2)


def constraint_system(fs: FeatSystem, constr_coords, site: int, precision: str):
    """(A_s (F * S, K_exp), b_s (F * S, 1)) for the constraint frames."""
    f = constr_coords.shape[0]
    gz, _, _ = _basis(fs, constr_coords, site, precision)
    s_all = fs.cmap.shape[0]
    rows = torch.zeros((f, s_all, fs.k_exp), dtype=gz.dtype, device=gz.device)
    cols = torch.arange(s_all, device=gz.device)
    rows[:, cols, fs.site_groups] = 1.0
    basis_cols = fs.g + fs.site_groups[:, None] * fs.n_basis + torch.arange(
        fs.n_basis, device=gz.device
    )
    rows[:, cols[:, None], basis_cols] = gz[:, fs.site_groups, :]
    b = torch.zeros((f, s_all), dtype=gz.dtype, device=gz.device)
    b[:, site] = 1.0
    return rows.reshape(f * s_all, fs.k_exp), b.reshape(-1, 1)


def check_fit(
    system,
    cfg: Dict,
    coords: torch.Tensor,  # (T, N, 3) float32, the fit's frames
    forces: torch.Tensor,
    constraint_frames: np.ndarray,
    sites: Sequence[int],
    coefs: Optional[torch.Tensor],  # (S, K_exp) the judged coefficients
    mapped: Optional[torch.Tensor],  # (T, S, 3) the judged mapped forces
    precision: str = "float64",
) -> Dict[str, float]:
    """Judge one fit at ``sites``.

    With ``coefs``/``mapped`` the program's outputs are judged. With
    ``coefs=None`` the fit is solved here in ``precision`` and that answer
    is judged, its mapped forces computed in the same precision (the
    control with ``"tf32"``; with ``"float64"`` the reference judges
    itself). Returns the largest over sites of ``obj_gap`` (objective over
    the float64 optimum's, less 1), ``constraint_viol`` (largest violation
    of a unit-scaled constraint row) and ``apply_err`` (largest mapped-force
    error over the site's root mean square).
    """
    dev = coords.device
    with full_precision():
        ref = FeatSystem(system, cfg, dev, torch.float64)
        low = None if coefs is not None else FeatSystem(system, cfg, dev, dtype_of(precision))
        constr64 = coords[torch.as_tensor(constraint_frames, device=dev)].double()
        out = {"obj_gap": -np.inf, "constraint_viol": 0.0, "apply_err": 0.0}
        for s in sites:
            gram = _gram(ref, coords, forces, s, "float64")
            p = gram + ref.l2 * torch.eye(ref.k_exp, dtype=gram.dtype, device=dev)
            a, b = constraint_system(ref, constr64, s, "float64")
            x_ref = eq_lstsq(p, a, b, "float64")
            if coefs is not None:
                x = coefs[s].double().reshape(-1, 1)
                judged_mapped = mapped[:, s, :]
            else:
                x, judged_mapped = _low_fit(low, coords, forces, constraint_frames, s, precision)
            j_ref = float(x_ref.T @ p @ x_ref)
            j_x = float(x.T @ p @ x)
            out["obj_gap"] = max(out["obj_gap"], (j_x - j_ref) / j_ref)
            out["constraint_viol"] = max(out["constraint_viol"], max_violation(a, x, b))
            out["apply_err"] = max(
                out["apply_err"], _apply_err(ref, coords, forces, s, x, judged_mapped)
            )
    return out


def _gram(fs: FeatSystem, coords, forces, site: int, precision: str) -> torch.Tensor:
    dt = fs.onehot.dtype
    gram = torch.zeros((fs.k_exp, fs.k_exp), dtype=dt, device=coords.device)
    for lo in range(0, coords.shape[0], FRAME_BLOCK):
        rows = design_rows(
            fs, coords[lo : lo + FRAME_BLOCK].to(dt), forces[lo : lo + FRAME_BLOCK].to(dt),
            site, precision,
        ).reshape(-1, fs.k_exp)
        gram += mm(rows.T, rows, precision)
    return gram


def _low_fit(fs: FeatSystem, coords, forces, constraint_frames, site: int, precision: str):
    """The fit of ``site`` solved and applied in ``precision``: (x (K, 1)
    float64, mapped forces (T, 3))."""
    dt = fs.onehot.dtype
    gram = _gram(fs, coords, forces, site, precision)
    p = gram + fs.l2 * torch.eye(fs.k_exp, dtype=dt, device=coords.device)
    cc = coords[torch.as_tensor(constraint_frames, device=coords.device)].to(dt)
    a, b = constraint_system(fs, cc, site, precision)
    x = eq_lstsq(p, a, b, precision)
    mapped = torch.cat(
        [
            mm(
                design_rows(
                    fs, coords[lo : lo + FRAME_BLOCK].to(dt),
                    forces[lo : lo + FRAME_BLOCK].to(dt), site, precision,
                ),
                x, precision,
            )[..., 0]
            for lo in range(0, coords.shape[0], FRAME_BLOCK)
        ]
    )
    return x.double(), mapped


def _apply_err(fs: FeatSystem, coords, forces, site: int, x, judged) -> float:
    """max |judged - X_s x| / rms(X_s x) over the fit's frames (float64)."""
    worst, sq, count = 0.0, 0.0, 0
    for lo in range(0, coords.shape[0], FRAME_BLOCK):
        exact = (
            design_rows(
                fs, coords[lo : lo + FRAME_BLOCK].double(),
                forces[lo : lo + FRAME_BLOCK].double(), site, "float64",
            )
            @ x
        )[..., 0]
        worst = max(worst, float(torch.max(torch.abs(judged[lo : lo + FRAME_BLOCK].double() - exact))))
        sq += float(torch.sum(exact * exact))
        count += exact.numel()
    return worst / max(np.sqrt(sq / count), 1e-300)


def coefs_from_program(coef_list: List[np.ndarray], device) -> torch.Tensor:
    """The program's per-site coefficients (``tags["coef_list"]``) as one
    (S, K_exp) float64 tensor in the layout above."""
    return torch.as_tensor(np.stack([np.asarray(c) for c in coef_list]), dtype=torch.float64, device=device)
