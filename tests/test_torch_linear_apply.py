"""The rank-2 apply: ``trjdot`` maps all frames as one 2-D product per chunk
of frames, against a float64 numpy product, and the NaN/inf semantics of
``TLinearMap`` and the separable apply around it."""

import numpy as np
import pytest
import torch

import aggforce_torch as pt
from aggforce_torch.map import SeperableTMap, TLinearMap
from aggforce_torch.map.torchlinear import fused_separable_apply
from aggforce_torch.ops import torchcore
from aggforce_torch.ops.torchcore import trjdot

N_ATOMS = 13
N_DIM = 3


def _frames(t, rng, dtype=np.float32):
    return rng.normal(size=(t, N_ATOMS, N_DIM)).astype(dtype)


def _one_frame(rng):
    return torch.as_tensor(_frames(1, rng)), rng.normal(size=(5, N_ATOMS))


def _no_frames(rng):
    return torch.as_tensor(_frames(0, rng)), rng.normal(size=(5, N_ATOMS))


def _ragged(rng):
    return torch.as_tensor(_frames(11, rng)), rng.normal(size=(5, N_ATOMS))


def _one_row(rng):
    return torch.as_tensor(_frames(9, rng)), rng.normal(size=(1, N_ATOMS))


def _one_hot(rng):
    onehot = np.zeros((4, N_ATOMS))
    onehot[np.arange(4), [0, 3, 7, 12]] = 1.0
    return torch.as_tensor(_frames(10, rng)), onehot


def _window(rng):
    """Frames sliced from a larger pool, every atom of a wider system kept
    but the last two: neither the frames nor the atoms are contiguous."""
    pool = torch.as_tensor(rng.normal(size=(30, N_ATOMS + 2, N_DIM)).astype(np.float32))
    return pool[7:19, :N_ATOMS], rng.normal(size=(6, N_ATOMS))


def _transposed(rng):
    stored = torch.as_tensor(rng.normal(size=(10, N_DIM, N_ATOMS)).astype(np.float32))
    return stored.transpose(1, 2), rng.normal(size=(6, N_ATOMS))


def _float64(rng):
    return torch.as_tensor(_frames(10, rng, np.float64)), rng.normal(size=(5, N_ATOMS))


CASES = {
    "one frame": _one_frame,
    "no frames": _no_frames,
    "ragged last chunk": _ragged,
    "one output row": _one_row,
    "one-hot map": _one_hot,
    "pool window": _window,
    "transposed view": _transposed,
    "float64": _float64,
}


def _budget_frames(monkeypatch, frames):
    """Lower the layout budget to ``frames`` frames of this system."""
    monkeypatch.setattr(torchcore, "_LAYOUT_BYTES", frames * N_ATOMS * N_DIM * 4)


@pytest.mark.parametrize("case", sorted(CASES), ids=lambda c: c.replace(" ", "-"))
def test_rank2_apply_matches_float64(monkeypatch, case):
    """trjdot and TLinearMap against a float64 product, in one chunk and in
    equal chunks of at most four frames (11 frames: 4, 4 and a ragged 3)."""
    points, matrix = CASES[case](np.random.default_rng(sorted(CASES).index(case)))
    dtype = points.dtype
    tol = dict(rtol=1e-12, atol=1e-12) if dtype == torch.float64 else dict(rtol=2e-5, atol=2e-5)
    expect = np.einsum("mn,tnd->tmd", matrix, points.double().numpy())
    factor = torch.as_tensor(matrix, dtype=dtype)
    tmap = TLinearMap(mapping=matrix, device="cpu")

    whole = trjdot(points, factor)
    _budget_frames(monkeypatch, 4)
    chunk = torchcore._chunk_frames(len(points), N_ATOMS * N_DIM * 4)
    assert chunk <= 4 and -(-len(points) // chunk) == -(-len(points) // 4)
    chunked = trjdot(points, factor)
    mapped = tmap(points)
    for out in (whole, chunked, mapped):
        assert out.shape == (points.shape[0], matrix.shape[0], N_DIM)
        assert out.dtype == dtype and out.is_contiguous()
        np.testing.assert_allclose(out.numpy(), expect, **tol)
    torch.testing.assert_close(chunked, whole, **tol)


def _nan_case_maps():
    """Coordinate and force maps whose atoms 4 and 9 carry no weight."""
    groups = [[0, 1], [2, 3], [5, 6, 7, 8], [10, 11, 12]]
    return (
        TLinearMap(groups, n_fg_sites=N_ATOMS, device="cpu"),
        pt.LinearMap(groups, n_fg_sites=N_ATOMS),
    )


@pytest.mark.parametrize(
    "atom, value, raises",
    [(4, np.nan, False), (9, np.nan, False), (2, np.nan, True), (12, np.nan, True),
     (6, np.inf, False), (6, -np.inf, False), (4, np.inf, False)],
)
def test_nan_and_inf_semantics(monkeypatch, atom, value, raises):
    """A NaN on a zero-weight atom is filled (the result is the zero-filled
    input's), on a weighted atom it raises, from ``__call__`` and from the
    separable apply alike; +/-inf propagates as in the numpy LinearMap. The
    bad value sits in the last of several chunks."""
    _budget_frames(monkeypatch, 3)
    tmap, lmap = _nan_case_maps()
    rng = np.random.default_rng(5)
    coords = _frames(10, rng)
    forces = _frames(10, rng)
    bad = forces.copy()
    bad[9, atom, 1] = value
    sep = SeperableTMap(coord_map=tmap, force_map=tmap)
    if raises:
        with pytest.raises(ValueError):
            tmap(torch.as_tensor(bad))
        with pytest.raises(ValueError):
            fused_separable_apply(tmap, tmap, torch.as_tensor(coords), torch.as_tensor(bad))
        with pytest.raises(ValueError):
            fused_separable_apply(tmap, tmap, torch.as_tensor(bad), torch.as_tensor(coords))
        with pytest.raises(ValueError):
            sep.map_arrays(coords, bad)
        return
    got = tmap(torch.as_tensor(bad))
    mc, mf = fused_separable_apply(tmap, tmap, torch.as_tensor(coords), torch.as_tensor(bad))
    torch.testing.assert_close(mf, got, rtol=0, atol=0, equal_nan=True)
    torch.testing.assert_close(mc, tmap(torch.as_tensor(coords)), rtol=0, atol=0)
    if np.isnan(value):
        filled = bad.copy()
        filled[np.isnan(filled)] = 0.0
        torch.testing.assert_close(got, tmap(torch.as_tensor(filled)), rtol=0, atol=0)
        assert torch.isfinite(got).all()
        return
    expect = lmap(bad)
    got = got.numpy()
    for kind in (np.isposinf, np.isneginf, np.isnan):
        np.testing.assert_array_equal(kind(got), kind(expect))
    fin = np.isfinite(expect)
    assert fin.any() and not fin.all()
    np.testing.assert_allclose(got[fin], expect[fin], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mode", ["backward", "vjp", "jacfwd", "jacrev"])
def test_nan_fill_is_differentiable(monkeypatch, mode):
    """The NaN-filling apply differentiates as the NaN->0 ``where`` it
    replaced (gradient 0 at the NaN), over several chunks: the map itself
    under autograd and ``torch.func.vjp`` (as a Gaussian premap's VJP
    runs it), the filled ``trjdot`` under the forward and reverse
    Jacobians (the map's raise is host control flow, which a batched
    forward pass cannot take)."""
    _budget_frames(monkeypatch, 3)
    tmap, _ = _nan_case_maps()
    factor = tmap.torch_standard_matrix("cpu")
    rng = np.random.default_rng(9)
    points = torch.as_tensor(_frames(7, rng))
    points[5, 4, 1] = np.nan  # a zero-weight atom
    weight = torch.as_tensor(rng.normal(size=(7, factor.shape[0], N_DIM)).astype(np.float32))

    def where(x):
        return torch.matmul(factor[None], torch.where(torch.isnan(x), 0.0, x))

    def filled(x):
        return trjdot(x, factor, fill_nan=True)

    if mode == "backward":
        got = points.clone().requires_grad_()
        ref = points.clone().requires_grad_()
        (tmap(got) * weight).sum().backward()
        (where(ref) * weight).sum().backward()
        got, ref = got.grad, ref.grad
    elif mode == "vjp":
        got = torch.func.vjp(tmap, points)[1](weight)[0]
        ref = torch.func.vjp(where, points)[1](weight)[0]
    else:
        jac = getattr(torch.func, mode)
        got, ref = jac(filled)(points), jac(where)(points)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, ref, rtol=1e-6, atol=1e-6)
    if got.shape == points.shape:
        assert got[5, 4, 1] == 0.0
