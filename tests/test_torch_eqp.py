"""Port parity: the shared-factor equality-QP solver against the JAX package's."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aggforce_torch.ops import eqp as peqp

from aggforce_tpu.ops import eqp as jeqp


def _problems(seed, f=2, s=3, n=12, m=4):
    """SPD cost matrices shared by f fits, each with sampled constraint rows."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(s, 3 * n, n))
    P = (np.einsum("sti,stj->sij", x, x) + 0.1 * np.eye(n)).astype(np.float32)
    A = rng.normal(size=(f, s, m, n)).astype(np.float32)
    B = rng.normal(size=(f, s, m, 1)).astype(np.float32)
    return P, A, B


def _resid(P, A, B, x):
    """Per-problem max equilibrated constraint violation, in float64."""
    A = A.astype(np.float64)
    norm = np.linalg.norm(A, axis=3, keepdims=True)
    return np.abs((A / norm) @ x.astype(np.float64) - B / norm).max(axis=(2, 3))


def _solve_port(P, A, B, **kw):
    x, r = peqp.batched_eqp_solve_shared(
        *map(torch.as_tensor, (P, A, B)), return_resid=True, **kw
    )
    return x.numpy(), r.numpy()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_shared_solve_matches_jax(seed):
    P, A, B = _problems(seed)
    xj, rj = jeqp.batched_eqp_solve_shared(
        *map(jnp.asarray, (P, A, B)), iters=10, return_resid=True
    )
    xp, rp = _solve_port(P, A, B, iters=10)
    xj = np.asarray(xj)
    assert np.linalg.norm(xp - xj) <= 1e-4 * np.linalg.norm(xj)
    assert np.max(np.asarray(rj)) <= 1e-4
    assert np.max(rp) <= 1e-4
    assert np.max(_resid(P, A, B, xp)) <= 1e-4


@pytest.mark.parametrize("seed", [3, 4])
def test_shared_solve_matches_host_oracle(seed):
    P, A, B = _problems(seed)
    xp, _ = _solve_port(P, A, B, iters=10)
    for f in range(A.shape[0]):
        for s in range(A.shape[1]):
            expect = peqp.eqp_solve_host(P[s], A[f, s], B[f, s])
            np.testing.assert_array_equal(
                expect, jeqp.eqp_solve_host(P[s], A[f, s], B[f, s])
            )
            # the device solve regularizes by delta=1e-6 of the mean trace
            assert np.linalg.norm(xp[f, s] - expect) <= 1e-3 * np.linalg.norm(expect)


@pytest.mark.parametrize("seed", [5, 6])
@pytest.mark.parametrize("repeat_rows", [False, True], ids=["distinct", "repeated-rows"])
def test_batched_kkt_solve_is_the_host_oracle(seed, repeat_rows):
    """The oracle's method batched in torch float64 gives the oracle's
    answer, also where constraint rows repeat exactly (each site's own row
    over the sampled frames): the same equilibration, the same regularized
    KKT matrix and refinement, only LAPACK's sums in another order."""
    P, A, B = _problems(seed)
    if repeat_rows:
        A[:, :, 1] = A[:, :, 0]
        B[:, :, 1] = B[:, :, 0]
    f, s, m, n = A.shape
    flat = lambda x: torch.as_tensor(x, dtype=torch.float64).reshape(f * s, *x.shape[2:])  # noqa: E731
    x, resid = peqp.batched_eqp_solve_kkt(
        torch.as_tensor(P, dtype=torch.float64).expand(f, s, n, n).reshape(f * s, n, n),
        flat(A), flat(B),
    )
    assert x.dtype == torch.float64 and float(resid.max()) <= 1e-12
    for i in range(f):
        for j in range(s):
            expect = peqp.eqp_solve_host(P[j], A[i, j], B[i, j])
            np.testing.assert_allclose(x[i * s + j].numpy(), expect, rtol=1e-9, atol=1e-12)


def test_single_fit_bit_equal_to_fit_in_batch():
    """Per-problem masking makes a fit's numbers independent of its batch."""
    P, A, B = _problems(5, f=4)
    xb, rb = _solve_port(P, A, B, iters=40)
    for f in range(A.shape[0]):
        x1, r1 = _solve_port(P, A[f : f + 1], B[f : f + 1], iters=40)
        np.testing.assert_array_equal(x1[0], xb[f])
        np.testing.assert_array_equal(r1[0], rb[f])


def test_direct_z_route_matches_inverse_route(monkeypatch):
    P, A, B = _problems(6, f=1, n=16, m=6)
    x_inv, r_inv = _solve_port(P, A, B, iters=10)
    # f*m <= 2n holds, so lowering the size threshold selects direct-Z
    monkeypatch.setattr(peqp, "_DIRECT_Z_N_THRESHOLD", 8)
    x_dz, r_dz = _solve_port(P, A, B, iters=10)
    assert np.linalg.norm(x_dz - x_inv) <= 1e-4 * np.linalg.norm(x_inv)
    assert max(r_dz.max(), r_inv.max()) <= 1e-4


def test_equilibrate_matches_jax():
    P, A, B = _problems(7)
    expect = jeqp._equilibrate(jnp.asarray(P), jnp.asarray(A[0]), jnp.asarray(B[0]))
    got = peqp._equilibrate(*map(torch.as_tensor, (P, A[0], B[0])))
    for e, g in zip(expect, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(e), rtol=1e-6, atol=1e-7)


def test_lazy_shift_escalates_only_failing_problems():
    """A failed factorization (info > 0, even with a finite partial factor)
    takes the next shift; a problem that fails every level comes back NaN."""
    P, _, _ = _problems(8)
    M = torch.as_tensor(P / np.trace(P, axis1=1, axis2=2)[:, None, None])
    M[1] = -M[1]  # negative definite: fails at the small shift
    chol = peqp._lazy_shift_factor(M, [1e-6, 10.0])
    eye = torch.eye(M.shape[-1])
    torch.testing.assert_close(chol[0], torch.linalg.cholesky(M[0] + 1e-6 * eye))
    torch.testing.assert_close(chol[1], torch.linalg.cholesky(M[1] + 10.0 * eye))
    M[2] = -10 * M[2] - eye  # fails every level
    chol = peqp._lazy_shift_factor(M, [1e-6, 1e-3])
    assert torch.isnan(chol[2]).all()
    assert torch.isfinite(chol[0]).all()


def _per_problem(seed, s=3, n=12, m=4, k=2):
    """Per-problem SPD cost matrices, constraint rows and targets."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(s, 3 * n, n))
    P = (np.einsum("sti,stj->sij", x, x) + 0.1 * np.eye(n)).astype(np.float32)
    A = rng.normal(size=(s, m, n)).astype(np.float32)
    B = rng.normal(size=(s, m, k)).astype(np.float32)
    return P, A, B


def _batched_resid(A, B, x):
    """Per-problem max equilibrated constraint violation, in float64."""
    A = A.astype(np.float64)
    norm = np.linalg.norm(A, axis=2, keepdims=True)
    return np.abs((A / norm) @ x.astype(np.float64) - B / norm).max(axis=(1, 2))


@pytest.mark.parametrize("seed, rho", [(10, 0.0), (11, 0.0), (12, 1.0)])
def test_batched_auglag_matches_jax(seed, rho):
    P, A, B = _per_problem(seed)
    xj, rj = jeqp.batched_eqp_solve_auglag(
        *map(jnp.asarray, (P, A, B)), rho=rho, return_resid=True
    )
    xp, rp = peqp.batched_eqp_solve_auglag(
        *map(torch.as_tensor, (P, A, B)), rho=rho, return_resid=True
    )
    xj, xp = np.asarray(xj), xp.numpy()
    assert np.abs(xp - xj).max() <= 1e-4 * np.abs(xj).max()
    assert max(np.asarray(rj).max(), rp.numpy().max()) <= 1e-4
    assert _batched_resid(A, B, xp).max() <= 1e-4


def test_single_auglag_matches_jax():
    P, A, B = _per_problem(13, s=1)
    xj, rj = jeqp.eqp_solve_auglag(
        *map(jnp.asarray, (P[0], A[0], B[0])), return_resid=True
    )
    xp, rp = peqp.eqp_solve_auglag(
        *map(torch.as_tensor, (P[0], A[0], B[0])), return_resid=True
    )
    assert xp.shape == (12, 2) and rp.shape == ()
    assert np.abs(xp.numpy() - np.asarray(xj)).max() <= 1e-4 * np.abs(xj).max()
    assert max(float(rj), float(rp)) <= 1e-4


def test_auglag_single_problem_bit_equal_in_batch():
    """Per-problem masking: a problem's numbers do not depend on its batch."""
    P, A, B = _per_problem(17, s=4)
    xb, rb = peqp.batched_eqp_solve_auglag(
        *map(torch.as_tensor, (P, A, B)), iters=40, return_resid=True
    )
    for s in range(P.shape[0]):
        x1, r1 = peqp.eqp_solve_auglag(
            *map(torch.as_tensor, (P[s], A[s], B[s])), iters=40, return_resid=True
        )
        torch.testing.assert_close(x1, xb[s], rtol=0, atol=0)
        torch.testing.assert_close(r1, rb[s], rtol=0, atol=0)


def _dependent_rows(seed, f=3, s=2, n=12, m=6):
    """Shared-factor problems whose constraint rows repeat (a singular Schur
    complement, so the lazy shift escalates)."""
    P, A, B = _problems(seed, f=f, s=s, n=n, m=m)
    A[:, :, m // 2 :] = A[:, :, : m // 2]
    B[:, :, m // 2 :] = B[:, :, : m // 2]
    return P, A, B


@pytest.mark.parametrize("make", [_problems, _dependent_rows], ids=["random", "dependent-rows"])
@pytest.mark.parametrize("solver", ["shared", "auglag"])
def test_host_checks_off_gives_the_same_solve(make, solver):
    """``host_checks=False`` (every shift level, every sweep, selected on the
    device) returns the bits of the host-checked solve."""
    P, A, B = (torch.as_tensor(x) for x in make(21))
    outs = []
    for host_checks in (True, False):
        if solver == "shared":
            outs.append(peqp.batched_eqp_solve_shared(
                P, A, B, iters=40, return_resid=True, host_checks=host_checks
            ))
        else:
            s_dim = P.shape[0]
            outs.append(peqp.batched_eqp_solve_auglag(
                P, A[0, :s_dim], B[0, :s_dim], iters=40, return_resid=True,
                host_checks=host_checks,
            ))
    for a, b in zip(*outs):
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)


@pytest.mark.parametrize(
    "resid, tol, values, finite, want",
    [
        (np.nan, np.inf, (np.ones(3),), None, False),
        (1e-5, 1e-4, (np.array([[1.0, np.inf]]),), None, False),
        (
            np.array([1e-5, 2e-4, 1e-5, 1e-5, np.nan]),
            1e-4,
            (np.array([[1.0, 2.0], [1.0, 2.0], [np.nan, 2.0], [1.0, 2.0], [1.0, 2.0]]),),
            np.array([True, True, True, False, True]),
            np.array([True, False, False, False, False]),
        ),
        (np.float32(1e9), np.inf, (np.ones((2, 3)), np.zeros(4)), None, True),
    ],
    ids=["nan-resid", "inf-value", "per-site", "tol-inf"],
)
def test_converged_is_the_nan_aware_escalation_rule(resid, tol, values, finite, want):
    """A device solve stands only where its residual is at most tol and its
    values are finite: a NaN residual escalates even under tol = inf, a
    value is reduced over the axes past the residual's (one flag a site),
    a device finiteness flag counts as a value, and a scalar residual gives
    a bool."""
    got = peqp.converged(resid, tol, *values, finite=finite)
    if np.ndim(want) == 0:
        assert got is want
    else:
        np.testing.assert_array_equal(got, want)
