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
