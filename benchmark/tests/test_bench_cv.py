"""The cross-validated study cell (``cln025_ca_cv.study``) at a CPU size of
its own: a sound run is correct and reports its metrics, and a table that
is stale, averaged over four of the five folds or 1% high reads incorrect
under the cell's own limits; ``work`` counts the grid's fold Grams."""

import copy

import pytest
import torch

from benchmark import harness, systems

NAME = "cln025_ca_cv.study"


def _cell(trace=False):
    """The cell cut to 40 atoms, 300-frame windows and two featurizers
    (n_basis 2 and 3); its l2 values, folds and limits as configured."""
    cell = harness.load_cell(NAME, trace)
    cfg = copy.deepcopy(cell.config)
    cfg["system"].update({"n_atoms": 40, "bonded_pairs": {"start": 0, "stop": 10, "step": 2}, "cg_stride": 8})
    cfg["grid"] = {"n_basis": [2, 3], "outer": [8.0], "width": [1.0]}
    traffic = dict(cell.traffic, pool_frames=1500, frames_per_fit=300, warm_frames=300)
    return harness.Cell(NAME, cfg, traffic, cell.limits, cell.metrics, cell.chips)


def _run(cell, trace=False):
    return harness.run_cell(cell, 2**35 + 23, 0.6, trace, torch.device("cpu"), lambda m: None)


@pytest.mark.parametrize("trace", [False, True])
def test_sound_run_is_correct(trace):
    out = _run(_cell(trace), trace)
    assert out["correct"], out["checks"]
    assert set(out["checks"]) == set(harness.load_cell(NAME, False).limits)
    want = {"cv.escalated_cells_per_fit"} if trace else {"frames_per_s", "setup_s"}
    assert set(out["metrics"]) == want


def _stale(monkeypatch):
    """Each CV returns the table of the first window it scored."""
    import aggforce_torch as agg

    original = agg.project_forces_grid_cv
    first = {}

    def stale(cv_arg_dict, *args, **kwargs):
        key = tuple(sorted(cv_arg_dict))
        if key not in first:
            first[key] = original(cv_arg_dict, *args, **kwargs)
        return first[key]

    monkeypatch.setattr(agg, "project_forces_grid_cv", stale)


def _four_folds(monkeypatch):
    """Each table averages the scores of the first four folds only."""
    from aggforce_torch.qp import cv

    original = cv._score_table
    monkeypatch.setattr(
        cv, "_score_table", lambda l2s, qf, denoms: original(l2s, qf[:, :-1], denoms[:-1])
    )


def _high(monkeypatch):
    """Every mean score comes out 1% high."""
    from aggforce_torch.qp import cv

    original = cv._score_table

    def high(l2s, qf, denoms):
        return {l2: (1.01 * m, sd, n) for l2, (m, sd, n) in original(l2s, qf, denoms).items()}

    monkeypatch.setattr(cv, "_score_table", high)


@pytest.mark.parametrize("fault", [_stale, _four_folds, _high])
def test_fault_makes_the_run_incorrect(monkeypatch, fault):
    fault(monkeypatch)
    out = _run(_cell())
    assert out["attempted"] >= 1
    assert not out["correct"], out["checks"]


def test_work_counts_the_grid_fold_grams():
    """3 T S K (K + 1) for each of the 12 featurizers, K = 145 (1 + n_basis)
    with n_basis 5, 7 and 9 four times each, S = 10."""
    cell = harness.load_cell(NAME, False)
    shapes = systems.shapes(systems.build_system(cell.config), cell.config)
    assert (shapes["G"], shapes["S"]) == (145, 10)
    t = 10_000
    expect = 4 * sum(3.0 * t * 10 * k * (k + 1) for k in (870, 1160, 1450))
    assert cell.check.work(shapes, t) == pytest.approx(expect, rel=1e-12)


def _traced(device_ops):
    """A traced one-study run of the cell on the given device operations."""
    from types import SimpleNamespace

    from benchmark import tracing

    cell = harness.load_cell(NAME, True)
    return SimpleNamespace(
        cell=cell, shapes=systems.shapes(systems.build_system(cell.config), cell.config),
        frames_per_fit=10_000, fit_seconds=[3.9],
        trace=tracing.Trace(window=(0.0, 4.0), device_ops=device_ops),
    )


def test_fold_gram_roofline_reads_the_fp64_product_only():
    """The row build counts beside the fp64 product; a program whose Grams
    take the 3xTF32 product (which launches the same build) reads nothing,
    not a share of the build alone."""
    m = harness.load_module(harness.BENCH_DIR / "metrics" / "site_grams_f64_roofline.py")
    build = ("void gram_tc::site_grams_build(gram_tc::Operands, float*, int, int, int)", 0.0, 0.05)
    tf32 = ("void gram_tc::site_grams_product<(anonymous namespace)::FlatStore>(CUtensorMap)", 0.05, 0.15)
    f64 = ("(anonymous namespace)::site_grams_product_f64(float const*, double*, int)", 0.15, 0.45)
    assert m.read(_traced([build, tf32])) is None
    run = _traced([build, f64])
    least = max(run.cell.check.work(run.shapes, 10_000) / m.FP64_FLOPS,
                m.nbytes(run, 10_000) / m.HBM_BYTES_PER_S)
    assert m.read(run) == pytest.approx(100.0 * least / 0.35)
    assert 0.0 < m.read(run) <= 100.0


def test_lu_time_reads_the_double_batched_lu_only():
    """MAGMA's double-precision batched LU kernels count; the float32
    Cholesky of a program that solves the CV otherwise does not."""
    m = harness.load_module(harness.BENCH_DIR / "metrics" / "cv.lu_ms_per_fit.py")
    lu = [
        ("void gemm_template_batched_nn_kernel<double, 16, 16, 48, 32, 16, 16, 16, 16, 16, 0, 0>(int)", 0.0, 0.5),
        ("dlaswp_rowparallel_kernel_batched", 0.5, 0.6),
        ("void batch_trsm_left_kernel<double, 64, 4, 3, false, false, true>(int)", 0.6, 0.8),
        ("zcomputecolumn_kernel_shared_batched", 0.8, 0.9),
        ("dswap_kernel_batched", 0.9, 1.0),
        ("idamax_kernel_batched", 1.0, 1.1),
    ]
    other = [
        ("void trsm_template_batched_lNL_kernel<float, 16, 16>(int)", 1.1, 1.3),
        ("void gemm_template_batched_tn_kernel<float, 16, 8, 64, 40, 16, 16, 8, 16, 8, 1, 0>(int)", 1.3, 1.4),
        ("void potrf_syrk_nc_kernel<float, 5, 6, 3, 3, 4>(int)", 1.4, 1.6),
    ]
    assert m.read(_traced(other)) is None
    assert m.read(_traced(lu + other)) == pytest.approx(1e3 * 1.1)  # one study
