"""The work arithmetic of the roofline shares and the idle share."""

import pytest

from benchmark import harness, peaks, systems, tracing


def _metric(name):
    return harness.load_module(harness.BENCH_DIR / "metrics" / f"{name}.py")


def _shapes(config):
    cfg = harness.load_json(harness.BENCH_DIR / "configs" / f"{config}.json")
    return systems.shapes(systems.build_system(cfg), cfg)


def test_kernel1_work_at_cln025_by_hand():
    shapes = _shapes("cln025_ca")
    assert (shapes["G"], shapes["S"], shapes["K_exp"]) == (145, 10, 1160)
    m = _metric("site_grams.roofline_pct")
    flops = m.flops(shapes, 10_000)
    assert flops == pytest.approx(3 * 10_000 * 10 * 1160 * 1161)
    assert flops == pytest.approx(4.04e11, rel=1e-3)
    least = peaks.least_seconds(flops, m.nbytes(shapes, 10_000))
    assert least == pytest.approx(0.816e-3, rel=1e-3)  # operations bound it


def test_kernel2_and_linear_work_at_solvated():
    shapes = _shapes("solvated_1500")
    assert (shapes["G"], shapes["S"], shapes["K_exp"], shapes["R"]) == (1125, 66, 9000, 1125)
    k2 = _metric("site_grams_tiled.roofline_pct")
    assert k2.flops(shapes, 20_000) == pytest.approx(3 * 20_000 * 66 * 9000 * 9001)
    lin = _metric("linear_gram.roofline_pct")
    assert lin.flops(shapes, 100_000) == pytest.approx(3 * 100_000 * 1125 * 1126)
    # 3.8e11 flops at 495 TFLOP/s: 0.768 ms; the forces' 1.8 GB at 3.35 TB/s: 0.537 ms
    least = peaks.least_seconds(lin.flops(shapes, 100_000), lin.nbytes(shapes, 100_000))
    assert least == pytest.approx(3 * 100_000 * 1125 * 1126 / 495e12)


def test_roofline_reads_its_kernels_only():
    trace = tracing.Trace(
        window=(0.0, 1.0),
        device_ops=[
            ("void site_grams_build(Operands, float*, int, int, int)", 0.1, 0.2),
            ("void gram_tc::site_grams_product<(anonymous namespace)::FlatStore>(CUtensorMap, double*)", 0.2, 0.4),
            ("void gram_tc::site_grams_product<(anonymous namespace)::PairStore>(CUtensorMap, double*)", 0.5, 0.6),
            ("void cutlass::Kernel2<cutlass_80_simt_sgemm_128x128_8x4_nt_align1>", 0.6, 0.9),
        ],
    )
    assert trace.kernel_seconds(_metric("site_grams.roofline_pct").KERNELS) == pytest.approx(0.3)
    assert trace.kernel_seconds(_metric("site_grams_tiled.roofline_pct").KERNELS) == pytest.approx(0.2)
    assert trace.kernel_seconds(_metric("linear_gram.roofline_pct").KERNELS) == pytest.approx(0.3)
    assert trace.kernel_seconds(("nothing",)) is None
    assert tracing.short_name(trace.device_ops[1][0]) == (
        "void gram_tc::site_grams_product<(anonymous namespace)::FlatStore>"
    )


def test_idle_share_is_the_union_of_overlapping_intervals():
    trace = tracing.Trace(
        window=(10.0, 20.0),
        device_ops=[
            ("a", 9.0, 11.0),  # clipped to the window: 1 s
            ("b", 12.0, 15.0),
            ("c", 13.0, 14.0),  # inside b: counted once
            ("d", 14.5, 16.0),  # overlaps b's end
            ("e", 19.0, 21.0),  # clipped: 1 s
        ],
    )
    # busy: [10, 11] + [12, 16] + [19, 20] = 6 s; a sum of durations reads 10.5
    assert trace.busy_s() == pytest.approx(6.0)
    assert trace.gaps() == [(11.0, 12.0), (16.0, 19.0)]
    run = harness.Run(cell=None, shapes={}, frames_per_fit=1, trace=trace)
    assert _metric("device.idle_pct").read(run) == pytest.approx(40.0)


def test_breakdown_names_gaps_by_span_and_host_operator():
    trace = tracing.Trace(
        window=(0.0, 10.0),
        device_ops=[("k1(int)", 0.0, 2.0), ("k2", 5.0, 10.0)],
        spans=[("bench.fit", 0.0, 10.0)],
        host_ops=[("aten::linalg_solve", 1.0, 6.0), ("aten::copy_", 2.5, 3.0)],
    )
    out = trace.breakdown()
    assert out["device_ops"] == [["k2", 5.0], ["k1", 2.0]]
    # the gap [2, 5] has its midpoint 3.5 under linalg_solve, outside copy_
    assert out["idle_gaps"] == [["bench.fit/aten::linalg_solve", 3.0]]


def test_fit_mfu_counts_the_gram_over_the_window():
    shapes = _shapes("cln025_ca")
    cell = type("C", (), {"traffic": {"check": "featurized"}})()
    trace = tracing.Trace(window=(0.0, 2.0), device_ops=[("k", 0.0, 1.0)])
    run = harness.Run(cell=cell, shapes=shapes, frames_per_fit=10_000, fit_seconds=[0.1] * 20, trace=trace)
    # 20 fits x 4.04e11 flops at 495 TFLOP/s is 16.3 ms of a 2 s window
    assert _metric("fit_mfu").read(run) == pytest.approx(100 * 20 * 3 * 10_000 * 10 * 1160 * 1161 / 495e12 / 2.0)


def test_readers_return_nothing_without_a_trace():
    run = harness.Run(cell=None, shapes={}, frames_per_fit=1)
    for name in ("site_grams.roofline_pct", "site_grams_tiled.roofline_pct",
                 "linear_gram.roofline_pct", "device.idle_pct", "escalated_sites_per_fit",
                 "fit_mfu"):
        assert _metric(name).read(run) is None
