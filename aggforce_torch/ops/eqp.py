"""Equality-constrained quadratic program solvers (torch).

Counterpart of the JAX package's ``ops/eqp.py``. The per-CG-site QPs

    minimize  x^T P x      subject to  A x = b

have equality constraints only, so the KKT conditions are linear and a
factor-once/solve-many range-space (Schur-complement) method replaces the
reference's iterative OSQP loop. This module provides:

  * :func:`batched_eqp_solve_shared` — many fits sharing the same per-site
    cost matrices P: each P is factorized once and reused by every fit;
  * :func:`eqp_solve_host` — the float64 numpy/LAPACK oracle, the
    escalation target of every fit.

The linear algebra goes to cuSOLVER/cuBLAS through ``torch.linalg``
(``cholesky_ex``, ``cholesky_inverse``, ``cholesky_solve``). The JAX
package's ``ops/blocked_chol.py`` has no counterpart: it exists only to stop
XLA from unrolling the factorizations on the TPU.
"""

from typing import Optional

import numpy as np
import torch

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


def _lazy_shift_factor(M: torch.Tensor, shifts) -> torch.Tensor:
    """Factor (b, n, n) SPD matrices, escalating diagonal shifts lazily.

    Tries ``shifts[0]`` for the whole batch; only when some problem's
    factorization fails is the next level computed and substituted for
    exactly the failing problems (one host sync per level tried). Problems
    that fail every level get a NaN factor, as the JAX twin's non-finite
    Cholesky, so the escalation downstream sees them. ``shifts`` entries
    are (b,)- or scalar-shaped shift magnitudes.
    """
    b, n = M.shape[0], M.shape[-1]
    eye = torch.eye(n, dtype=M.dtype, device=M.device)

    def shifted(s):
        s = torch.as_tensor(s, dtype=M.dtype, device=M.device).expand(b)
        return M + s[:, None, None] * eye

    chol, info = torch.linalg.cholesky_ex(shifted(shifts[0]))
    bad = _factor_bad(chol, info)
    for level in shifts[1:]:
        if not bool(bad.any()):
            break
        repl, info = torch.linalg.cholesky_ex(shifted(level))
        chol = torch.where(bad[:, None, None], repl, chol)
        bad = bad & _factor_bad(repl, info)
    if bool(bad.any()):
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
):
    """Range-space solve + early-exit refinement.

    Given Z = M^{-1} A^T, lambda comes from the m x m Schur complement
    S = A M^{-1} A^T (factored with the same lazy shift escalation —
    redundant constraint rows occur routinely for frame-sampled
    orthogonality systems), x = Z lambda, then refinement sweeps on the
    constraint residual until every problem is below ``refine_tol``. S is
    applied through its explicit inverse, computed once, as in the JAX
    twin. Returns (x, per-problem max |An x - Bn|).
    """
    m = An.shape[1]
    S = torch.matmul(An, Z)
    # f32 rounding through Z leaves S slightly asymmetric and, for
    # near-dependent sampled rows, indefinite by O(eps * cond): symmetrize
    # and escalate the diagonal shift only as far as each problem needs
    S = 0.5 * (S + S.transpose(1, 2))
    s_scale = torch.diagonal(S, dim1=1, dim2=2).sum(-1) / m + 1e-30  # (b,)
    chol_s = _lazy_shift_factor(
        S, [s_scale * delta, s_scale * delta_fallback, s_scale * 3e-2]
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
        if bool(done.all()):
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


def _site_factor_chol(P: torch.Tensor, delta, delta_fallback) -> torch.Tensor:
    """Equilibrate + lazily-shifted Cholesky per site (no inverse)."""
    return _lazy_shift_factor(_normalize_p(P), [delta, delta_fallback])


def _site_factor_inv(P: torch.Tensor, delta, delta_fallback) -> torch.Tensor:
    """Equilibrate + lazily-shifted Cholesky + explicit inverse per site."""
    return torch.cholesky_inverse(_site_factor_chol(P, delta, delta_fallback))


def _shared_schur_stage(
    op: torch.Tensor,  # (s, n, n) per-site inverses OR Cholesky factors
    A: torch.Tensor,  # (f, s, m, n)
    B: torch.Tensor,  # (f, s, m, k)
    delta: float,
    delta_fallback: float,
    iters: int,
    op_is_factor: bool = False,
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
    x, resid = _schur_tail(Z, An, Bn, delta, delta_fallback, iters, _REFINE_TOL)
    return x.reshape(f, s, n, -1), resid.reshape(f, s)


def batched_eqp_solve_shared(
    P: torch.Tensor,
    A: torch.Tensor,
    B: torch.Tensor,
    delta: float = 1e-6,
    delta_fallback: float = 3e-4,
    iters: int = 10,
    return_resid: bool = False,
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
    """
    f, m, n = A.shape[0], A.shape[2], A.shape[3]
    if n > _DIRECT_Z_N_THRESHOLD and f * m <= 2 * n:
        # solve-based Z: factor once per site, skip the explicit inverse
        chol = _site_factor_chol(P, delta, delta_fallback)
        x, resid = _shared_schur_stage(
            chol, A, B, delta, delta_fallback, iters, op_is_factor=True
        )
    else:
        minv = _site_factor_inv(P, delta, delta_fallback)
        x, resid = _shared_schur_stage(minv, A, B, delta, delta_fallback, iters)
    if return_resid:
        return x, resid
    return x


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
