"""Port parity: the linear and featurized cross validation against the JAX
package's."""

import numpy as np
import pytest
import torch

import aggforce_torch as pt
from aggforce_torch import agg as pagg
from aggforce_torch.qp import cv as pcv
from aggforce_torch.qp import fusedfeat as pff
from aggforce_torch.qp.qplinear import fit_routes
from aggforce_torch.utils.synth import synthesize_trajectory

import aggforce_tpu as jt
import aggforce_tpu.utils  # noqa: F401  (_featurizer reads jt.utils.Curry)
from aggforce_tpu import agg as jagg
from aggforce_tpu.qp import cv as jcv
from aggforce_tpu.qp import fusedfeat as jff

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
    """A canonical featurized grid no longer waits: fast=True and fast="auto"
    both take the single pass, with the same scores, and they match the JAX
    package's single pass for the same rng."""
    coords, forces = system
    common = dict(
        coords=coords[:90], forces=forces[:90], n_folds=2, constrained_inds=GROUPS,
        kbt=0.7, n_constraint_frames=5,
    )
    got = {
        fast: pagg.project_forces_grid_cv(
            {"l2_regularization": [1e3]}, rng=np.random.default_rng(0), fast=fast,
            coord_map=pt.LinearMap(SITES[:2], n_fg_sites=N_ATOMS),
            method=pt.qp_feat_linear_map, featurizer=_featurizer(pt, 3), device="cpu",
            **common,
        )
        for fast in (True, "auto")
    }
    expect = jagg.project_forces_grid_cv(
        {"l2_regularization": [1e3]}, rng=np.random.default_rng(0), fast=True,
        coord_map=jt.LinearMap(SITES[:2], n_fg_sites=N_ATOMS),
        method=jt.qp.qp_feat_linear_map, featurizer=_featurizer(jt, 3), **common,
    )
    assert got[True] == got["auto"]
    (score,) = got[True][pagg.SCORES_KNAME].values()
    (jscore,) = expect[jagg.SCORES_KNAME].values()
    assert score == pytest.approx(jscore, rel=1e-4)
    assert list(got[True][pagg.NRUNS_KNAME].values()) == [2]


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


# The featurized CV. Its l2 grid stays where the problems are well
# regularized: at l2 = 10 on this system each float32 CV, the JAX package's
# and the port's, lies ~3e-4 off the float64 oracle (the solver's fixed
# ridge, delta = 1e-6 of the mean trace, weighs against a small l2), so a
# 1e-4 comparison there measures float32 arithmetic, not the port.
FEAT_L2S = [1e2, 1e3]
FEAT_SITES = SITES[:3]


def _featurizer(package, n_basis=4, outer=2.0):
    return package.qp.Multifeaturize(
        [package.qp.id_feat, package.utils.Curry(package.qp.gb_feat, outer=outer, n_basis=n_basis)]
    )


def _spec(module, n_basis=4, include_id=True):
    return module.GBFeatSpec(outer=2.0, n_basis=n_basis, include_id=include_id)


@pytest.fixture(scope="module")
def feat_system(system):
    coords, forces = system
    return coords[:150], forces[:150]


@pytest.mark.parametrize("include_id", [True, False], ids=["id+gb", "gb"])
def test_fused_gb_cv_matches_jax(feat_system, include_id):
    coords, forces = feat_system
    kw = dict(l2_values=FEAT_L2S, n_folds=3, n_constraint_frames=6)
    expect = jcv.fused_gb_cv(
        coords, forces, jt.LinearMap(FEAT_SITES, n_fg_sites=N_ATOMS), GROUPS, 0.7,
        _spec(jff, include_id=include_id), rng=np.random.default_rng(5), **kw,
    )
    got = pcv.fused_gb_cv(
        coords, forces, pt.LinearMap(FEAT_SITES, n_fg_sites=N_ATOMS), GROUPS, 0.7,
        _spec(pff, include_id=include_id), rng=np.random.default_rng(5),
        device="cpu", **kw,
    )
    _assert_tables_close(got, expect)


def test_fused_gb_cv_grid_matches_jax(feat_system):
    coords, forces = feat_system
    kw = dict(l2_values=FEAT_L2S, n_folds=3, n_constraint_frames=6)
    expect = jcv.fused_gb_cv_grid(
        coords, forces, jt.LinearMap(FEAT_SITES, n_fg_sites=N_ATOMS), GROUPS, 0.7,
        [_spec(jff, 3), _spec(jff, 4)], rng=np.random.default_rng(8), **kw,
    )
    got = pcv.fused_gb_cv_grid(
        coords, forces, pt.LinearMap(FEAT_SITES, n_fg_sites=N_ATOMS), GROUPS, 0.7,
        [_spec(pff, 3), _spec(pff, 4)], rng=np.random.default_rng(8), device="cpu",
        **kw,
    )
    _assert_tables_close(got, expect)


@pytest.mark.parametrize(
    "grid", ["featurizer+l2", "featurizer", "l2"], ids=lambda g: g
)
def test_featurized_grid_cv_matches_jax(feat_system, grid):
    """project_forces_grid_cv(fast=True) routes a canonical featurized grid
    to the single pass; labels mirror the generic refit loop's."""
    coords, forces = feat_system

    def grid_of(package):
        out = {}
        if "featurizer" in grid:
            out["featurizer"] = [_featurizer(package, 3), _featurizer(package, 4)]
        if "l2" in grid:
            out["l2_regularization"] = FEAT_L2S
        return out

    def kw_of(package):
        kw = dict(
            coord_map=package.LinearMap(FEAT_SITES, n_fg_sites=N_ATOMS),
            constrained_inds=GROUPS, method=package.qp.qp_feat_linear_map, kbt=0.7,
            n_constraint_frames=6, rng=np.random.default_rng(6), fast=True, n_folds=3,
        )
        if "featurizer" not in grid:
            kw["featurizer"] = _featurizer(package)
        if "l2" not in grid:
            kw["l2_regularization"] = 1e3
        return kw

    expect = jagg.project_forces_grid_cv(grid_of(jt), coords, forces, **kw_of(jt))
    got = pagg.project_forces_grid_cv(
        grid_of(pt), coords, forces, device="cpu", **kw_of(pt)
    )
    assert [label._fields for label in got[pagg.SCORES_KNAME]] == [
        label._fields for label in expect[jagg.SCORES_KNAME]
    ]
    for gk, ek in zip(got[pagg.SCORES_KNAME], expect[jagg.SCORES_KNAME]):
        if "l2_regularization" in gk._fields:
            assert gk.l2_regularization == ek.l2_regularization
        assert got[pagg.SCORES_KNAME][gk] == pytest.approx(
            expect[jagg.SCORES_KNAME][ek], rel=1e-4
        )
        assert got[pagg.NRUNS_KNAME][gk] == 3
    if "featurizer" in grid:
        feats = grid_of(pt)["featurizer"]
        assert [type(k.featurizer) for k in got[pagg.SCORES_KNAME]] == [
            type(feats[0])
        ] * len(got[pagg.SCORES_KNAME])


def _problem(coords, forces, rng_seed, **kw):
    return pcv._featurized_cv_problem(
        coords, forces, pt.LinearMap(FEAT_SITES, n_fg_sites=N_ATOMS), GROUPS, 0.7,
        _spec(pff), 3, 6, np.random.default_rng(rng_seed), device="cpu", **kw,
    )


def test_featurized_cv_escalation_is_counted_and_equals_oracle(feat_system):
    """resid_tol=0 sends every (l2, fold) cell to the float64 oracle: the
    cells are counted, and the scores are the oracle's on the same Grams."""
    coords, forces = feat_system
    kw = dict(l2_values=FEAT_L2S, n_folds=3, n_constraint_frames=6, device="cpu")
    cmap = pt.LinearMap(FEAT_SITES, n_fg_sites=N_ATOMS)
    fit_routes.clear()
    escalated = pcv.fused_gb_cv(
        coords, forces, cmap, GROUPS, 0.7, _spec(pff), rng=np.random.default_rng(2),
        resid_tol=0.0, **kw,
    )
    assert fit_routes["cv_escalated_cells"] == len(FEAT_L2S) * 3
    grams, rows, b_all, folds, _ = _problem(coords, forces, 2)
    cells = np.ones((len(FEAT_L2S), 3), dtype=bool)
    qf = pcv._host_featurized_scores(
        *(x.numpy().astype(np.float64) for x in (grams, rows, b_all)), FEAT_L2S,
        np.zeros(cells.shape, dtype=np.float32), cells,
    )
    denoms = np.array([3 * len(f) * len(FEAT_SITES) for f in folds], dtype=np.float64)
    for i, l2 in enumerate(FEAT_L2S):
        assert escalated[l2][0] == pytest.approx(float((qf[i] / denoms).mean()), rel=1e-12)


def test_featurized_cv_cells_near_float64_oracle(feat_system):
    """Every float32 cell lies within 1e-4 of the same solve in float64 (the
    problem the solver poses), and that within 2e-3 of the float64 oracle.
    The solver (JAX's algorithm) factors the normalized train Gram plus a
    fixed ridge, 1e-6 of its mean diagonal, and refines only the
    constraints: the ridge biases the scores against the oracle, by 1.8e-3
    at l2 = 1e2 and 4.3e-4 at 1e3 on this system, in float64 too."""
    coords, forces = feat_system
    l2s = [1e2, 1e3, 1e4]
    grams, rows, b_all, folds, _ = _problem(coords, forces, 2)
    got, resid = pcv._featurized_solve_scores(
        grams, rows, b_all, torch.tensor(l2s, dtype=torch.float32)
    )
    assert float(resid.max()) <= 1e-4
    posed, _ = pcv._featurized_solve_scores(
        *(x.double() for x in (grams, rows, b_all)), torch.tensor(l2s, dtype=torch.float64)
    )
    np.testing.assert_allclose(got.numpy(), posed.numpy(), rtol=1e-4)
    exact = pcv._host_featurized_scores(
        *(x.numpy().astype(np.float64) for x in (grams, rows, b_all)), l2s,
        np.zeros((3, 3)), np.ones((3, 3), dtype=bool),
    )
    np.testing.assert_allclose(posed.numpy(), exact, rtol=2e-3)


def test_featurized_cv_refit_identity(feat_system):
    """A CV cell is the holdout force_smoothness of the map refitted on the
    fold's train frames with the fold's constraint frames (rtol 2e-3, as
    tests/test_cv_fast.py:118)."""
    coords, forces = feat_system
    grams, rows, b_all, folds, samples = _problem(coords, forces, 4)
    qf, resid = pcv._featurized_solve_scores(
        grams, rows, b_all, torch.tensor([1e3], dtype=torch.float32)
    )
    assert float(resid.max()) <= 1e-4
    train = np.concatenate(folds[1:])
    position = {int(f): i for i, f in enumerate(train)}

    class FoldSample:
        def choice(self, n, size, replace):
            return np.array([position[int(f)] for f in samples[0]])

    refit = pff.fused_gb_linear_map(
        pt.Trajectory(coords=coords[train], forces=forces[train]),
        pt.LinearMap(FEAT_SITES, n_fg_sites=N_ATOMS), kbt=0.7, spec=_spec(pff),
        constraints=GROUPS, l2_regularization=1e3, n_constraint_frames=6,
        constraint_rng=FoldSample(), device="cpu",
    )
    _, mapped = refit.map_arrays(coords[folds[0]], forces[folds[0]])
    cell = float(qf[0, 0]) / (3 * len(folds[0]) * len(FEAT_SITES))
    np.testing.assert_allclose(cell, pagg.force_smoothness(mapped), rtol=2e-3)
