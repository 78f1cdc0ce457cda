"""Equality-constrained quadratic program solvers (torch).

Counterpart of the JAX package's ``ops/eqp.py``. The per-CG-site QPs

    minimize  x^T P x      subject to  A x = b

have equality constraints only, so the KKT conditions are linear and a
factor-once/solve-many range-space (Schur-complement) method replaces the
reference's iterative OSQP loop. This module provides:

  * :func:`eqp_solve_auglag` / :func:`batched_eqp_solve_auglag` — the
    per-problem device solver: augmented operator, lazily shifted Cholesky,
    Schur tail with early-exit refinement and a residual per problem;
  * :func:`batched_eqp_solve_shared` — many fits sharing the same per-site
    cost matrices P: each P is factorized once and reused by every fit;
    :func:`batched_eqp_solve_shared_mesh` splits it over a mesh's ranks;
  * :func:`eqp_solve_host` — the float64 numpy/LAPACK oracle, the
    escalation target of every fit, and :func:`batched_eqp_solve_kkt`, the
    same method batched in torch (the cross validation's float64 solve on
    the card);
  * :func:`converged` — the one rule that decides, from a device solve's
    residual and values, whether it stands or escalates to the oracle.

The linear algebra goes to cuSOLVER/cuBLAS through ``torch.linalg``
(``cholesky_ex``, ``cholesky_inverse``, ``cholesky_solve``). Each solver
entry point runs inside ``utils.device.full_fp32()``: its float32 products
stay full float32 whatever TF32 setting the process has chosen, as the JAX
twin's ``precision="highest"``. The JAX
package's ``ops/blocked_chol.py`` has no counterpart: it exists only to stop
XLA from unrolling the factorizations on the TPU.
"""

from typing import Optional

import numpy as np
import torch

from ..parallel.mesh import as_frame_mesh
from ..utils.device import full_fp32
from ..utils.prof import span

# Refinement sweeps stop once the equilibrated constraint violation falls
# below this (comfortably below the 1e-4 escalation tolerance, at the f32
# noise floor).
_REFINE_TOL = 5e-7

# Above this operator dimension the shared-factor solver skips the explicit
# per-site inverse when the total right-hand-side work is small (f*m <= 2n):
# Z = M^{-1} A^T then comes from a Cholesky solve, ~n^2*m FLOPs per site
# instead of the inverse's ~2n^3. The explicit inverse amortizes across
# many fits sharing one factor (f*m >> n). The route is a shape-only
# choice, as in the JAX package.
_DIRECT_Z_N_THRESHOLD = 4096


def _factor_bad(chol: torch.Tensor, info: torch.Tensor) -> torch.Tensor:
    """(b,) mask of failed factorizations.

    The JAX package tests ``~isfinite(chol)``; ``cholesky_ex`` may instead
    return a finite partial factor with ``info > 0``, so both count.
    """
    return (info > 0) | ~torch.isfinite(chol).all(dim=(1, 2))


def _lazy_shift_factor(M: torch.Tensor, shifts, host_checks: bool = True) -> torch.Tensor:
    """Factor (b, n, n) SPD matrices, escalating diagonal shifts lazily.

    Tries ``shifts[0]`` for the whole batch; only when some problem's
    factorization fails is the next level computed and substituted for
    exactly the failing problems (one host sync per level tried). Problems
    that fail every level get a NaN factor, as the JAX twin's non-finite
    Cholesky, so the escalation downstream sees them. ``shifts`` entries
    are (b,)- or scalar-shaped shift magnitudes. ``host_checks=False``
    computes every level and selects per problem on the device, with no
    host sync: the same factors, for the price of the unused levels.
    """
    b, n = M.shape[0], M.shape[-1]
    eye = torch.eye(n, dtype=M.dtype, device=M.device)

    def shifted(s):
        s = torch.as_tensor(s, dtype=M.dtype, device=M.device).expand(b)
        return M + s[:, None, None] * eye

    chol, info = torch.linalg.cholesky_ex(shifted(shifts[0]))
    bad = _factor_bad(chol, info)
    for level in shifts[1:]:
        if host_checks and not bool(bad.any()):
            break
        repl, info = torch.linalg.cholesky_ex(shifted(level))
        chol = torch.where(bad[:, None, None], repl, chol)
        bad = bad & _factor_bad(repl, info)
    if not host_checks or bool(bad.any()):
        chol = torch.where(bad[:, None, None], torch.nan, chol)
    return chol


def _schur_tail(
    Z: torch.Tensor,  # (b, n, m) = M^{-1} A^T per problem
    An: torch.Tensor,  # (b, m, n) row-equilibrated constraints
    Bn: torch.Tensor,  # (b, m, k) equilibrated targets
    delta: float,
    delta_fallback: float,
    iters: int,
    refine_tol: float,
    host_checks: bool = True,
):
    """Range-space solve + early-exit refinement.

    Given Z = M^{-1} A^T, lambda comes from the m x m Schur complement
    S = A M^{-1} A^T (factored with the same lazy shift escalation —
    redundant constraint rows occur routinely for frame-sampled
    orthogonality systems), x = Z lambda, then refinement sweeps on the
    constraint residual until every problem is below ``refine_tol``. S is
    applied through its explicit inverse, computed once, as in the JAX
    twin. Returns (x, per-problem max |An x - Bn|). ``host_checks=False``
    runs all ``iters`` sweeps without asking the host whether every problem
    is done; a done problem takes no update, so the result is the same.
    """
    m = An.shape[1]
    S = torch.matmul(An, Z)
    # f32 rounding through Z leaves S slightly asymmetric and, for
    # near-dependent sampled rows, indefinite by O(eps * cond): symmetrize
    # and escalate the diagonal shift only as far as each problem needs
    S = 0.5 * (S + S.transpose(1, 2))
    s_scale = torch.diagonal(S, dim1=1, dim2=2).sum(-1) / m + 1e-30  # (b,)
    chol_s = _lazy_shift_factor(
        S, [s_scale * delta, s_scale * delta_fallback, s_scale * 3e-2], host_checks
    )
    sinv = torch.cholesky_inverse(chol_s)  # (b, m, m)

    x = torch.matmul(Z, torch.matmul(sinv, Bn))
    resid = Bn - torch.matmul(An, x)

    def done_mask(r):
        # per-problem convergence, NaN-aware both ways: a problem whose
        # residual has gone non-finite counts as done (further sweeps
        # cannot rescue it — escalation owns it), and it must not stall
        # or prolong refinement for healthy batch-mates
        finite = torch.isfinite(r).all(dim=(1, 2))
        small = torch.amax(torch.abs(r), dim=(1, 2)) <= refine_tol
        return small | ~finite

    for _ in range(max(0, iters)):
        done = done_mask(resid)
        if host_checks and bool(done.all()):
            break
        # per-problem masking: a converged (or non-finite) problem receives
        # no further updates while its batch neighbors keep refining, so a
        # single fit and the same fit inside a batch run the same sequence
        step = torch.matmul(Z, torch.matmul(sinv, resid))
        x = torch.where(done[:, None, None], x, x + step)
        r_new = Bn - torch.matmul(An, x)
        resid = torch.where(done[:, None, None], resid, r_new)
    return x, torch.amax(torch.abs(resid), dim=(1, 2))


def _normalize_p(P: torch.Tensor) -> torch.Tensor:
    """Unit-mean-trace, symmetrized copy of (b, n, n) cost matrices."""
    n = P.shape[-1]
    p_scale = torch.diagonal(P, dim1=1, dim2=2).sum(-1) / n + 1e-30
    Pn = P / p_scale[:, None, None]
    return 0.5 * (Pn + Pn.transpose(1, 2))


def _equilibrate(P, A, B):
    """Batched normalization: unit-mean-trace P, unit-norm constraint rows.

    Scaling the objective does not move the minimizer and row-scaling
    consistent constraints does not change the feasible set; without this,
    data-scale imbalance (force Grams reach 1e9+) makes the relative
    regularization swamp the constraint rows.
    """
    row_norm = torch.linalg.norm(A, dim=2, keepdim=True) + 1e-30
    return _normalize_p(P), A / row_norm, B / row_norm


def _site_factor_chol(P: torch.Tensor, delta, delta_fallback, host_checks=True) -> torch.Tensor:
    """Equilibrate + lazily-shifted Cholesky per site (no inverse)."""
    return _lazy_shift_factor(_normalize_p(P), [delta, delta_fallback], host_checks)


def _site_factor_inv(P: torch.Tensor, delta, delta_fallback, host_checks=True) -> torch.Tensor:
    """Equilibrate + lazily-shifted Cholesky + explicit inverse per site."""
    return torch.cholesky_inverse(_site_factor_chol(P, delta, delta_fallback, host_checks))


def _shared_schur_stage(
    op: torch.Tensor,  # (s, n, n) per-site inverses OR Cholesky factors
    A: torch.Tensor,  # (f, s, m, n)
    B: torch.Tensor,  # (f, s, m, k)
    delta: float,
    delta_fallback: float,
    iters: int,
    op_is_factor: bool = False,
    host_checks: bool = True,
):
    """Per-fit stage of the shared-factor solve: equilibrate, Z, Schur tail.

    ``op_is_factor=True`` means ``op`` holds the per-site Cholesky factors
    and Z comes from a Cholesky solve instead of an inverse product.
    """
    f, s, m, n = A.shape
    row_norm = torch.linalg.norm(A, dim=3, keepdim=True) + 1e-30
    An = (A / row_norm).reshape(f * s, m, n)
    Bn = (B / row_norm).reshape(f * s, B.shape[2], B.shape[3])
    op_b = op.expand(f, s, n, n).reshape(f * s, n, n)
    if op_is_factor:
        Z = torch.cholesky_solve(An.transpose(1, 2), op_b)
    else:
        Z = torch.matmul(op_b, An.transpose(1, 2))
    x, resid = _schur_tail(
        Z, An, Bn, delta, delta_fallback, iters, _REFINE_TOL, host_checks
    )
    return x.reshape(f, s, n, -1), resid.reshape(f, s)


@span("aggforce.solve")
@full_fp32()
def batched_eqp_solve_shared(
    P: torch.Tensor,
    A: torch.Tensor,
    B: torch.Tensor,
    delta: float = 1e-6,
    delta_fallback: float = 3e-4,
    iters: int = 10,
    return_resid: bool = False,
    host_checks: bool = True,
):
    r"""Many equality-QP fits sharing per-site cost matrices P.

    P: (s, n, n); A: (f, s, m, n); B: (f, s, m, k) -> (f, s, n, k): fit f of
    site s solves min x^T P_s x s.t. A[f,s] x = B[f,s]. Each site's
    augmented operator M_s = P_s + delta I is factorized once and reused by
    every fit (the classic range-space Schur method; P must be positive
    definite, which l2-regularized feature Grams are). The per-problem
    residual diagnostic catches any conditioning failure for float64
    escalation.

    With ``return_resid=True`` also returns the (f, s) residual matrix.
    ``host_checks=False`` enqueues the whole solve without a host sync
    (every shift level computed, every refinement sweep run, each problem
    selecting its own on the device), with the same results.
    """
    f, m, n = A.shape[0], A.shape[2], A.shape[3]
    if n > _DIRECT_Z_N_THRESHOLD and f * m <= 2 * n:
        # solve-based Z: factor once per site, skip the explicit inverse
        chol = _site_factor_chol(P, delta, delta_fallback, host_checks)
        x, resid = _shared_schur_stage(
            chol, A, B, delta, delta_fallback, iters, op_is_factor=True,
            host_checks=host_checks,
        )
    else:
        minv = _site_factor_inv(P, delta, delta_fallback, host_checks)
        x, resid = _shared_schur_stage(
            minv, A, B, delta, delta_fallback, iters, host_checks=host_checks
        )
    if return_resid:
        return x, resid
    return x


@full_fp32()
def batched_eqp_solve_shared_mesh(
    P: torch.Tensor,
    A: torch.Tensor,
    B: torch.Tensor,
    mesh,
    delta: float = 1e-6,
    delta_fallback: float = 3e-4,
    iters: int = 10,
    return_resid: bool = False,
    host_checks: bool = True,
):
    r""":func:`batched_eqp_solve_shared` split over the ranks of a mesh.

    Two axes of the solve ride the mesh (a ``parallel.FrameMesh``), as in
    the JAX package's ``shard_map`` version:

      * the per-site factorization and explicit inverse, the window's fixed
        cost, is split over SITES (padded to a multiple of the mesh size
        with identity problems), and one all-gather gives every rank all
        the inverses;
      * the per-fit Schur stage is split over FITS (padded by repeating the
        last fit), and one all-gather of the fits' solutions and residuals
        gives every rank all of them.

    Every rank takes the whole (replicated) P, A and B and returns the
    whole result. Each problem's arithmetic does not depend on the batch it
    is in, so the result matches the replicated solver's inverse route per
    problem; the inverse route is always taken.
    """
    fm = as_frame_mesh(mesh)
    f, s, n = A.shape[0], A.shape[1], P.shape[-1]
    pad_f, pad_s = (-f) % fm.size, (-s) % fm.size
    if pad_f:
        A = torch.cat([A, A[-1:].expand(pad_f, *A.shape[1:])])
        B = torch.cat([B, B[-1:].expand(pad_f, *B.shape[1:])])
    if pad_s:
        eye = torch.eye(n, dtype=P.dtype, device=P.device)
        P = torch.cat([P, eye.expand(pad_s, n, n)])
    s_lo, s_hi = fm.shard_bounds(s + pad_s)
    f_lo, f_hi = fm.shard_bounds(f + pad_f)
    minv = fm.all_gather(
        _site_factor_inv(P[s_lo:s_hi], delta, delta_fallback, host_checks)
    )[:s]
    x_loc, r_loc = _shared_schur_stage(
        minv, A[f_lo:f_hi], B[f_lo:f_hi], delta, delta_fallback, iters,
        host_checks=host_checks,
    )
    x = fm.all_gather(x_loc)[:f]
    if return_resid:
        return x, fm.all_gather(r_loc)[:f]
    return x


@span("aggforce.solve")
@full_fp32()
def batched_eqp_solve_auglag(
    P: torch.Tensor,
    A: torch.Tensor,
    B: torch.Tensor,
    rho: float = 0.0,
    delta: float = 1e-6,
    delta_fallback: float = 3e-4,
    iters: int = 10,
    return_resid: bool = False,
    host_checks: bool = True,
):
    r"""Batched direct range-space equality-QP solve (Cholesky only).

    Solves min x^T P x s.t. A x = b per batch entry through the augmented
    operator M = P + rho A^T A + delta I (same minimizer; rho bounds the
    condition number along constraint directions). P: (s, n, n); A:
    (s, m, n); B: (s, m, k) -> (s, n, k). M is factored with the lazy shift
    escalation (delta, then delta_fallback, for the failing problems only),
    Z = M^{-1} A^T comes from a Cholesky solve, and the Schur tail gives x
    with at most ``iters`` refinement sweeps.

    With ``return_resid=True`` also returns the (s,) per-problem max
    equilibrated constraint violation ``max |An x - Bn|``, the diagnostic
    callers use to escalate unconverged solves to the float64 oracle.
    ``host_checks=False`` enqueues the solve without a host sync, with the
    same results (see :func:`batched_eqp_solve_shared`).
    """
    Pn, An, Bn = _equilibrate(P, A, B)
    AnT = An.transpose(1, 2)
    # the rho*A^T A term keeps M well-conditioned along constraint
    # directions even when P is (near-)singular there; the minimizer of
    # x^T P x s.t. Ax = b is unchanged by adding rho|Ax|^2
    M = Pn + rho * torch.matmul(AnT, An)
    chol_m = _lazy_shift_factor(M, [delta, delta_fallback], host_checks)
    Z = torch.cholesky_solve(AnT, chol_m)  # (s, n, m)
    x, resid = _schur_tail(
        Z, An, Bn, delta, delta_fallback, iters, _REFINE_TOL, host_checks
    )
    if return_resid:
        return x, resid
    return x


@span("aggforce.solve")
def eqp_solve_auglag(
    P: torch.Tensor,
    A: torch.Tensor,
    B: torch.Tensor,
    rho: float = 0.0,
    delta: float = 1e-6,
    delta_fallback: float = 3e-4,
    iters: int = 10,
    return_resid: bool = False,
):
    """Single-problem :func:`batched_eqp_solve_auglag` (batch of one).

    With ``return_resid=True`` the residual is a scalar.
    """
    out = batched_eqp_solve_auglag(
        P[None], A[None], B[None], rho=rho, delta=delta,
        delta_fallback=delta_fallback, iters=iters, return_resid=return_resid,
    )
    if return_resid:
        x, resid = out
        return x[0], resid[0]
    return out[0]


def converged(resid, tol: float, *values, finite=None):
    """Whether a float32 device solve stands, or must be redone in float64.

    True where the solver's residual is at most ``tol`` and every value the
    solve produced is finite. NaN-aware both ways: a NaN residual or a
    non-finite value fails, so it escalates. ``resid`` is a scalar or an
    array of per-site, per-fit or per-cell residuals; each value is reduced
    over its axes past ``resid``'s (an (S, K) coefficient array against (S,)
    residuals gives one flag a site). ``finite`` is a finiteness flag
    already taken on the device, shaped as ``resid``. The comparison is made
    in float64. Returns a bool for a scalar residual, else a bool array.
    """
    ok = np.asarray(resid, dtype=np.float64) <= tol
    for v in values:
        fin = np.isfinite(np.asarray(v))
        ok = ok & fin.all(axis=tuple(range(ok.ndim, fin.ndim)))
    if finite is not None:
        ok = ok & np.asarray(finite, dtype=bool)
    return bool(ok) if ok.ndim == 0 else ok


def eqp_solve_host(
    P: np.ndarray,
    A: np.ndarray,
    B: np.ndarray,
    delta: float = 1e-12,
    refine_iters: int = 4,
    rcond: Optional[float] = None,
) -> np.ndarray:
    """Float64 host oracle (LAPACK LU + refinement)."""
    import scipy.linalg as sl

    P = np.asarray(P, dtype=np.float64)
    A = np.asarray(A, dtype=np.float64)
    B = np.asarray(B, dtype=np.float64)
    n = P.shape[0]
    m = A.shape[0]
    # equilibrate (see _equilibrate): objective scale and constraint row
    # norms are normalized to O(1) without moving the primal solution.
    p_scale = np.trace(P) / n + 1e-300
    Pn = P / p_scale
    row_norm = np.linalg.norm(A, axis=1, keepdims=True) + 1e-300
    An = A / row_norm
    Bn = B / row_norm
    K_reg = np.block(
        [
            [Pn + delta * np.eye(n), An.T],
            [An, -delta * np.eye(m)],
        ]
    )
    K_true = np.block([[Pn, An.T], [An, np.zeros((m, m))]])
    lu, piv = sl.lu_factor(K_reg)
    rhs = np.concatenate([np.zeros((n,) + B.shape[1:]), Bn], axis=0)
    Z = sl.lu_solve((lu, piv), rhs)
    for _ in range(refine_iters):
        Z = Z + sl.lu_solve((lu, piv), rhs - K_true @ Z)
    return Z[:n]


def batched_eqp_solve_kkt(
    P: torch.Tensor,
    A: torch.Tensor,
    B: torch.Tensor,
    delta: float = 1e-12,
    refine_iters: int = 4,
):
    """:func:`eqp_solve_host`'s method, batched in torch on the inputs'
    device and dtype (float64 for the oracle's answer).

    P: (b, n, n); A: (b, m, n); B: (b, m, k) -> ((b, n, k) minimizers of
    x^T P x subject to A x = B, (b,) max equilibrated constraint violation
    ``max |An x - Bn|``). Equilibrates as the oracle does, factors the
    regularized KKT matrix [[Pn + delta I, An^T], [An, -delta I]] by LU and
    refines ``refine_iters`` times against the unregularized one, all
    without a host sync.
    """
    n, m = P.shape[-1], A.shape[-2]
    p_scale = torch.diagonal(P, dim1=-2, dim2=-1).sum(-1) / n + 1e-300
    Pn = P / p_scale[:, None, None]
    row_norm = torch.linalg.norm(A, dim=-1, keepdim=True) + 1e-300
    An, Bn = A / row_norm, B / row_norm
    k_true = torch.cat(
        [
            torch.cat([Pn, An.transpose(1, 2)], dim=2),
            torch.cat([An, An.new_zeros(An.shape[0], m, m)], dim=2),
        ],
        dim=1,
    )
    reg = torch.cat([P.new_full((n,), delta), P.new_full((m,), -delta)])
    lu, piv = torch.linalg.lu_factor(k_true + torch.diag(reg))
    rhs = torch.cat([Bn.new_zeros(Bn.shape[0], n, Bn.shape[2]), Bn], dim=1)
    z = torch.linalg.lu_solve(lu, piv, rhs)
    for _ in range(refine_iters):
        z = z + torch.linalg.lu_solve(lu, piv, rhs - torch.matmul(k_true, z))
    x = z[:, :n]
    resid = torch.amax(torch.abs(Bn - torch.matmul(An, x)), dim=(1, 2))
    return x, resid
