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
    cell = type("C", (), {"check": harness.load_check("featurized"), "chips": 1})()
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


def test_on_four_chips_the_work_is_shared_by_the_chips():
    """kernel 2's roofline sets an average rank's share of the fit's work
    (a fourth of the flops and Gram entries, every frame read) against
    rank 0's kernel time; ``fit_mfu`` the whole fits' work against four
    chips' peak over the window."""
    shapes = _shapes("solvated_1500")
    t = 100_000
    trace = tracing.Trace(
        window=(0.0, 20.0),
        device_ops=[("void gram_tc::site_grams_product<(anonymous namespace)::PairStore>(x)", 1.0, 7.0)],
    )
    one = type("C", (), {"check": harness.load_check("featurized"), "chips": 1})()
    four = type("C", (), {"check": harness.load_check("featurized"), "chips": 4})()
    runs = {c.chips: harness.Run(cell=c, shapes=shapes, frames_per_fit=t, fit_seconds=[9.0] * 2, trace=trace)
            for c in (one, four)}
    k2 = _metric("site_grams_tiled.roofline_pct")
    work = 3.0 * t * 66 * 9000 * 9001
    assert k2.read(runs[4]) == pytest.approx(100 * 2 * (work / 4) / 495e12 / 6.0)
    assert k2.read(runs[1]) == pytest.approx(100 * 2 * work / 495e12 / 6.0)
    assert k2.nbytes(shapes, t, 4) == pytest.approx(4.0 * (6 * t * 1500 + 66 * 9000 * 9001 / 8))
    mfu = _metric("fit_mfu")
    assert mfu.read(runs[4]) == pytest.approx(100 * 2 * work / (4 * 495e12) / 20.0)
    assert mfu.read(runs[4]) == pytest.approx(mfu.read(runs[1]) / 4)


def test_nccl_time_is_the_median_fit():
    """Three traced fits: NCCL kernels go to the fit whose ``bench.fit``
    span started last before them; one fit that waited long for a slow
    rank does not set the reading, and other kernels are not counted."""
    trace = tracing.Trace(
        window=(0.0, 30.0),
        device_ops=[
            ("ncclDevKernel_AllGather_RING_LL(ncclDevComm*, unsigned long, ncclWork*)", 8.0, 8.020),
            ("ncclDevKernel_AllGather_RING_LL(ncclDevComm*, unsigned long, ncclWork*)", 9.0, 9.002),
            ("void site_grams_build(Operands)", 10.5, 15.0),
            ("ncclDevKernel_AllGather_RING_LL(ncclDevComm*, unsigned long, ncclWork*)", 18.0, 18.400),
            ("ncclDevKernel_Broadcast_RING_LL(ncclDevComm*, unsigned long, ncclWork*)", 20.5, 20.518),
        ],
        spans=[("bench.fit", 0.1, 8.5), ("bench.gather", 8.9, 9.1),
               ("bench.fit", 10.0, 18.5), ("bench.fit", 20.0, 29.0)],
    )
    run = harness.Run(cell=None, shapes={}, frames_per_fit=1, fit_seconds=[9.0] * 3, trace=trace)
    # per fit 22, 400 and 18 ms; the mean would read 146.7
    assert _metric("nccl.device_ms_per_fit").read(run) == pytest.approx(22.0)
    quiet = tracing.Trace(window=(0.0, 30.0), device_ops=[("k", 1.0, 2.0)], spans=trace.spans)
    none = harness.Run(cell=None, shapes={}, frames_per_fit=1, fit_seconds=[9.0] * 3, trace=quiet)
    assert _metric("nccl.device_ms_per_fit").read(none) is None
