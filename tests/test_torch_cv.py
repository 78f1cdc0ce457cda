"""Port parity: the linear cross validation against the JAX package's."""

import numpy as np
import pytest

import aggforce_torch as pt
from aggforce_torch import agg as pagg
from aggforce_torch.qp import cv as pcv
from aggforce_torch.qp.qplinear import fit_routes
from aggforce_torch.utils.synth import synthesize_trajectory

import aggforce_tpu as jt
from aggforce_tpu import agg as jagg
from aggforce_tpu.qp import cv as jcv

N_ATOMS = 40
GROUPS = {frozenset((i, i + 1)) for i in range(0, 12, 2)}
SITES = [[i] for i in range(0, N_ATOMS, 6)]
L2S = [0.0, 1e1, 1e3]


@pytest.fixture(scope="module")
def system():
    base = np.random.default_rng(2).normal(scale=0.5, size=(N_ATOMS, 3))
    return synthesize_trajectory(base, GROUPS, 300, seed=4)


def _assert_tables_close(got, expect):
    assert got.keys() == expect.keys()
    for key, (mean, sd, n) in expect.items():
        g_mean, g_sd, g_n = got[key]
        assert g_n == n
        assert g_mean == pytest.approx(mean, rel=1e-4)
        assert g_sd == pytest.approx(sd, rel=1e-3)


@pytest.mark.parametrize(
    "constraints, n_folds", [(GROUPS, 3), (set(), 4)], ids=["pairs-3", "none-4"]
)
def test_linear_map_cv_matches_jax(system, constraints, n_folds):
    coords, forces = system
    kw = dict(l2_values=L2S, n_folds=n_folds)
    expect = jcv.linear_map_cv(
        coords, forces, jt.LinearMap(SITES, n_fg_sites=N_ATOMS), constraints,
        rng=np.random.default_rng(11), **kw,
    )
    got = pcv.linear_map_cv(
        coords, forces, pt.LinearMap(SITES, n_fg_sites=N_ATOMS), constraints,
        rng=np.random.default_rng(11), device="cpu", **kw,
    )
    _assert_tables_close(got, expect)


def test_cv_escalation_is_counted_and_keeps_scores(system):
    """resid_tol=0 recomputes every cell with the float64 oracle."""
    coords, forces = system
    cmap = pt.LinearMap(SITES, n_fg_sites=N_ATOMS)
    kw = dict(l2_values=L2S, n_folds=3, device="cpu")
    plain = pcv.linear_map_cv(coords, forces, cmap, GROUPS, rng=np.random.default_rng(1), **kw)
    fit_routes.clear()
    escalated = pcv.linear_map_cv(
        coords, forces, cmap, GROUPS, rng=np.random.default_rng(1), resid_tol=0.0, **kw
    )
    assert fit_routes["cv_escalated_cells"] == len(L2S) * 3
    _assert_tables_close(escalated, plain)


@pytest.mark.parametrize("fast", ["auto", False], ids=["single-pass", "refit-loop"])
def test_grid_cv_matches_jax(system, fast):
    """project_forces_grid_cv with constrained_inds="auto": the single-pass
    path (with its per-fold constraint probe) and the refit loop, each
    against the JAX package's same path with the same rng seed."""
    coords, forces = system
    expect = jagg.project_forces_grid_cv(
        {"l2_regularization": L2S}, coords, forces, n_folds=3,
        rng=np.random.default_rng(5), fast=fast,
        coord_map=jt.LinearMap(SITES, n_fg_sites=N_ATOMS),
    )
    got = pagg.project_forces_grid_cv(
        {"l2_regularization": L2S}, coords, forces, n_folds=3,
        rng=np.random.default_rng(5), fast=fast,
        coord_map=pt.LinearMap(SITES, n_fg_sites=N_ATOMS), device="cpu",
    )
    assert [tuple(k) for k in got[pagg.SCORES_KNAME]] == [
        tuple(k) for k in expect[jagg.SCORES_KNAME]
    ]
    for gk, ek in zip(got[pagg.SCORES_KNAME], expect[jagg.SCORES_KNAME]):
        assert got[pagg.SCORES_KNAME][gk] == pytest.approx(
            expect[jagg.SCORES_KNAME][ek], rel=1e-4
        )
        assert got[pagg.NRUNS_KNAME][gk] == expect[jagg.NRUNS_KNAME][ek] == 3


def test_single_pass_equals_refit_loop(system):
    coords, forces = system
    common = dict(
        coords=coords, forces=forces, n_folds=3, coord_map=pt.LinearMap(SITES, n_fg_sites=N_ATOMS),
        constrained_inds=GROUPS, device="cpu",
    )
    fast = pagg.project_forces_grid_cv(
        {"l2_regularization": L2S}, rng=np.random.default_rng(3), fast=True, **common
    )
    loop = pagg.project_forces_grid_cv(
        {"l2_regularization": L2S}, rng=np.random.default_rng(3), fast=False, **common
    )
    for label, score in loop[pagg.SCORES_KNAME].items():
        assert fast[pagg.SCORES_KNAME][label] == pytest.approx(score, rel=1e-4)


def test_featurized_grid_waits_for_its_single_pass(system):
    """A canonical featurized grid runs the refit loop under fast="auto" and
    raises under fast=True (its single-pass CV is not ported)."""
    coords, forces = system
    featurizer = pt.Multifeaturize([pt.id_feat, pt.Curry(pt.gb_feat, outer=2.0, n_basis=3)])
    common = dict(
        coords=coords[:90], forces=forces[:90], n_folds=2,
        coord_map=pt.LinearMap(SITES[:2], n_fg_sites=N_ATOMS), constrained_inds=GROUPS,
        method=pt.qp_feat_linear_map, featurizer=featurizer, kbt=0.7,
        n_constraint_frames=5, device="cpu",
    )
    with pytest.raises(NotImplementedError, match="Queue 1 item 8"):
        pagg.project_forces_grid_cv(
            {"l2_regularization": [1e3]}, rng=np.random.default_rng(0), fast=True, **common
        )
    out = pagg.project_forces_grid_cv(
        {"l2_regularization": [1e3]}, rng=np.random.default_rng(0), **common
    )
    (score,) = out[pagg.SCORES_KNAME].values()
    assert np.isfinite(score) and list(out[pagg.NRUNS_KNAME].values()) == [2]


def test_cv_helpers_match_jax():
    grid = {"a": [1, 2], "b": ["x", "y", "z"]}
    got, expect = pagg.process_cvargs(grid), jagg.process_cvargs(grid)
    assert [(tuple(lab), kw) for lab, kw in got] == [(tuple(lab), kw) for lab, kw in expect]
    for s in ([], [2.0], [1.0, 4.0, 6.5]):
        assert pagg.mean(s) == jagg.mean(s)
        assert pagg.sample_sd(s) == jagg.sample_sd(s)
    for n_l2, per, n_sys in ((5, 1 << 20, 3), (40, 1 << 28, 5), (2, 1, 1)):
        assert pcv._l2_blocks(n_l2, per, n_sys) == jcv._l2_blocks(n_l2, per, n_sys)
    folds = pcv._fold_segments(17, 4, np.random.default_rng(9))
    for f, e in zip(folds, jcv._fold_segments(17, 4, np.random.default_rng(9))):
        np.testing.assert_array_equal(f, e)
