"""The cross-validated hyperparameter study of the benchmark's
``cln025_ca_cv.study`` cell (``benchmark/entries/grid_cv.py``: detection,
the static-map control and the featurized grid, each CV through
``project_forces_grid_cv(fast=True)``) against the benchmark's float64
reference study, every fold refitted from its own train rows
(``benchmark/reference/cv.py``), at a CPU size: the cell's system cut to 40
atoms and 300 frames, a 2-featurizer x 2-l2 x 3-fold grid."""

import copy

import numpy as np
import pytest
import torch

from aggforce_torch import agg as pagg
from aggforce_torch.qp import cv as pcv
from benchmark import harness, systems
from benchmark.entries import grid_cv
from benchmark.reference import cv as reference

SEED = 2**33 + 21
L2S = [1e1, 1e3]
CPU = torch.device("cpu")

# Tolerances, relative to the reference, with the readings they were set
# from (program / the reference's TF32 mode, this size and seed). Scores
# and sds are held one l2 value at a time: the float32 fold Grams' rounding
# reaches a score amplified by the train system's conditioning, which the l2
# value sets.
SCORE_RTOL = {
    # program 2.8e-5 / TF32 4.3e-4: the float32 Grams at the small l2
    1e1: 1e-4,
    # program 2.8e-7 / TF32 5.3e-4: float32 rounding, well conditioned
    1e3: 1e-5,
}
SD_RTOL = {
    # the sd is a difference of fold scores, ~1% of them: program 8.0e-4 /
    # TF32 4.0e-3
    1e1: 2e-3,
    # program 4.2e-6 / TF32 1.5e-2
    1e3: 1e-4,
}
# the linear Gram and its float32 solve at l2 = 1e3 x member counts:
# program 2.2e-7 / TF32 2.8e-5
CONTROL_RTOL = 2e-6


@pytest.fixture(scope="module")
def study_setup():
    cfg = copy.deepcopy(harness.load_json(harness.BENCH_DIR / "configs" / "cln025_ca_cv.json"))
    cfg["system"].update({"n_atoms": 40, "bonded_pairs": {"start": 0, "stop": 10, "step": 2}, "cg_stride": 8})
    cfg["grid"] = {"n_basis": [2, 3], "outer": [8.0], "width": [1.0]}
    cfg["l2_regularization"] = L2S
    cfg["n_folds"] = 3
    system = systems.build_system(cfg)
    coords, forces = systems.make_pool(system, 300, SEED, CPU)
    return cfg, system, coords, forces


def _program(study_setup):
    cfg, system, coords, forces = study_setup
    state = grid_cv.prepare(system, cfg, CPU)
    return grid_cv.fit(state, coords, forces, np.random.default_rng(SEED))


def _reference(study_setup, precision):
    cfg, system, coords, forces = study_setup
    return reference.study(system, cfg, coords, forces, np.random.default_rng(SEED), precision)


@pytest.fixture(scope="module")
def program(study_setup):
    return _program(study_setup)


@pytest.fixture(scope="module")
def exact(study_setup):
    return _reference(study_setup, "float64")


def _rel(got, ref):
    return np.abs(np.asarray(got, dtype=np.float64) - ref) / np.abs(ref)


def _within(out, ref) -> dict:
    """Each quantity of a study against the reference: whether it holds its
    tolerance."""
    ok = {}
    for j, l2 in enumerate(L2S):
        ok[f"scores l2={l2:g}"] = bool(np.all(_rel(out["scores"][:, j], ref["scores"][:, j]) <= SCORE_RTOL[l2]))
        ok[f"sds l2={l2:g}"] = bool(np.all(_rel(out["sds"][:, j], ref["sds"][:, j]) <= SD_RTOL[l2]))
    ok["control"] = bool(_rel(out["control"], ref["control"]) <= CONTROL_RTOL)
    return ok


@pytest.mark.parametrize("quantity", ["scores", "sds", "control"])
def test_study_matches_the_refit_reference(program, exact, quantity):
    assert program["runs"].tolist() == [[3, 3], [3, 3]]
    assert {tuple(sorted(p)) for p in program["constraints"]} == exact["pairs"]
    ok = _within(program, exact)
    assert all(v for k, v in ok.items() if k.startswith(quantity)), (ok, program[quantity], exact[quantity])


def test_the_tf32_reference_fails_a_tolerance(exact, study_setup):
    ok = _within(_reference(study_setup, "tf32"), exact)
    assert not all(ok.values()), ok


def test_forced_escalation_equals_the_reference(study_setup, program, exact, monkeypatch):
    """Every (l2, fold) cell of both CVs sent to the float64 host oracle:
    all are counted, the featurized table is the device solve's (the same
    method in float64), and the table and the control (now float64, not the
    linear CV's float32 device solve) lie within every tolerance of the
    reference."""
    monkeypatch.setattr(
        pcv, "converged", lambda resid, tol, *values, **kw: np.zeros(np.shape(resid), dtype=bool)
    )
    out = _program(study_setup)
    assert out["escalated_sites"] == 2 * len(L2S) * 3 + 3
    np.testing.assert_allclose(out["scores"], program["scores"], rtol=1e-9)
    np.testing.assert_allclose(out["sds"], program["sds"], rtol=1e-6)
    assert all(_within(out, exact).values())


def test_the_study_takes_the_single_pass(study_setup, monkeypatch):
    """One single-pass CV a featurizer and one linear CV; the refit loop's
    project_forces is never called."""
    calls = {"fused_gb_cv": 0, "linear_map_cv": 0}

    def spy(name):
        original = getattr(pcv, name)

        def counted(*args, **kwargs):
            calls[name] += 1
            return original(*args, **kwargs)

        monkeypatch.setattr(pcv, name, counted)

    spy("fused_gb_cv")
    spy("linear_map_cv")

    def refit(*args, **kwargs):
        raise AssertionError("the refit loop ran")

    monkeypatch.setattr(pagg, "project_forces", refit)
    out = _program(study_setup)
    assert calls == {"fused_gb_cv": 2, "linear_map_cv": 1}
    assert np.isfinite(out["scores"]).all()
