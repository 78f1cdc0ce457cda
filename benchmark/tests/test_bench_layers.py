"""The layer attribution of a traced window (``benchmark/layers.py``) and
the six metrics that read it, on Chrome traces built by hand, and on a
tiny CPU run of a cell."""

import os
import subprocess
import sys

import pytest
import torch

from benchmark import harness, layers, tracing

LAYER_METRICS = [m["name"] for m in harness.load_json(layers.METRICS_FILE)]
US = 1e-6


def _metric(name):
    return harness.load_module(harness.BENCH_DIR / "metrics" / f"{name}.py")


def _x(name, cat, ts, dur, tid=1, corr=None):
    ev = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 1, "tid": tid}
    if corr is not None:
        ev["args"] = {"correlation": corr}
    return ev


def _doc(program=True):
    """A 1,000 us window on thread 1, one ``bench.fit`` call, times in us:

    host:  detect [40, 60]; entry [100, 900] holding solve [200, 600] and
           gram [650, 850]; cholesky [330, 440] inside solve
    launches (runtime call at -> device operation):
      50 detect  -> kernel 60-90        150 entry -> kernel 160-200
      210 solve  -> kernel 220-300      310 solve -> memcpy 300-330
      440 solve  -> kernel 450-500      660 gram  -> kernel 700-800
      980 none   -> kernel 990-1100 (clipped to the window's end)
      thread 2   -> kernel 870-880      no launch -> memset 520-530
    syncs: stream sync at 330 (solve), device sync at 950 (no span)

    ``program=False`` leaves out the aggforce spans and the runtime calls."""
    events = [
        _x("bench.window", "user_annotation", 0, 1000),
        _x("bench.fit", "user_annotation", 0, 1000),
        _x("aten::linalg_cholesky", "cpu_op", 330, 110),
        _x("void site_grams_build(Operands)", "kernel", 60, 30, corr=1),
        _x("cutlass_80_simt_sgemm_128x128_8x4_nt_align1", "kernel", 160, 40, corr=2),
        _x("trsm_kernel", "kernel", 220, 80, corr=3),
        _x("Memcpy DtoD (Device -> Device)", "gpu_memcpy", 300, 30, corr=4),
        _x("gemm_kernel", "kernel", 450, 50, corr=6),
        _x("void gram_tc::site_grams_product<FlatStore>(CUtensorMap)", "kernel", 700, 100, corr=7),
        _x("elementwise_kernel", "kernel", 990, 110, corr=9),
        _x("other_thread_kernel", "kernel", 870, 10, corr=10),
        _x("Memset (Device)", "gpu_memset", 520, 10, corr=11),
    ]
    if program:
        events += [
            _x("aggforce.detect", "user_annotation", 40, 20),
            _x("aggforce.entry", "user_annotation", 100, 800),
            _x("aggforce.solve", "user_annotation", 200, 400),
            _x("aggforce.gram", "user_annotation", 650, 200),
            _x("cudaLaunchKernel", "cuda_runtime", 50, 5, corr=1),
            _x("cudaLaunchKernel", "cuda_runtime", 150, 5, corr=2),
            _x("cudaLaunchKernel", "cuda_runtime", 210, 5, corr=3),
            _x("cudaMemcpyAsync", "cuda_runtime", 310, 5, corr=4),
            _x("cudaStreamSynchronize", "cuda_runtime", 330, 100, corr=5),
            _x("cuLaunchKernel", "cuda_driver", 440, 5, corr=6),
            _x("cudaLaunchKernel", "cuda_runtime", 660, 5, corr=7),
            _x("cudaDeviceSynchronize", "cuda_runtime", 950, 20, corr=8),
            _x("cudaLaunchKernel", "cuda_runtime", 980, 5, corr=9),
            _x("cudaLaunchKernel", "cuda_runtime", 250, 5, tid=2, corr=10),
            _x("aggforce.solve", "user_annotation", 250, 10, tid=2),
            {"ph": "f", "cat": "ac2g", "name": "ac2g", "id": 3, "ts": 220, "pid": 0, "tid": 7},
        ]
    return {"traceEvents": events}


def _run(trace, fits=2):
    cell = type("C", (), {"check": harness.load_check("featurized"), "chips": 1})()
    shapes = {"K_exp": 1160, "S": 10, "N": 175, "R": 1125}
    return harness.Run(cell=cell, shapes=shapes, frames_per_fit=10_000,
                       fit_seconds=[0.01] * fits, trace=trace)


def test_device_operations_belong_to_the_innermost_span_of_their_launch():
    tr = layers.parse_layer_trace(_doc())
    assert tr.layer_names() == ["aggforce.detect", "aggforce.entry", "aggforce.gram", "aggforce.solve"]
    # self time: solve's operations are not entry's, though entry covers solve
    expect = {
        "aggforce.detect": (30, 1), "aggforce.entry": (40, 1),
        "aggforce.solve": (110 + 50, 2),  # kernel 220-300 and memcpy 300-330 join
        "aggforce.gram": (100, 1),
        # late kernel clipped to 10, the other thread's launch and the
        # unlaunched memset are outside
        layers.OUTSIDE: (10 + 10 + 10, 2),
    }
    for layer, (us, kernels) in expect.items():
        assert tr.layer_device_seconds(layer) == pytest.approx(us * US), layer
        assert tr.layer_launches(layer) == kernels, layer
    assert tr.layer_syncs("aggforce.solve") == 1
    assert tr.layer_syncs(layers.OUTSIDE) == 1
    assert tr.layer_syncs("aggforce.entry") == 0
    cov = tr.coverage()
    assert cov["busy_s"] == pytest.approx(360 * US)
    assert sum(v for k, v in cov.items() if k != "busy_s") == pytest.approx(cov["busy_s"])


def test_idle_time_is_split_by_the_host_layer_self_time():
    tr = layers.parse_layer_trace(_doc())
    assert tr.layer_host_intervals("aggforce.entry") == pytest.approx(
        [(100 * US, 200 * US), (600 * US, 650 * US), (850 * US, 900 * US)]
    )
    # gaps [200,220] [330,450] [500,520] and [530,600] of [530,700]
    expect = {"aggforce.solve": 230, "aggforce.gram": 100, "aggforce.entry": 150,
              "aggforce.detect": 20, layers.OUTSIDE: 140}
    for layer, us in expect.items():
        assert tr.layer_idle_seconds(layer) == pytest.approx(us * US), layer
    assert sum(expect.values()) * US == pytest.approx(tr.window_s - tr.busy_s())


def test_layer_metrics_by_hand():
    run = _run(layers.parse_layer_trace(_doc()), fits=2)
    expect = {
        "solve.device_ms_per_fit": 0.160 / 2,
        "solve.idle_ms_per_fit": 0.230 / 2,
        "solve.host_syncs_per_fit": 1 / 2,
        "gram.device_ms_per_fit": 0.100 / 2,
        "detect.launches_per_fit": 1 / 2,
        "apply.device_ms_per_fit": None,  # no aggforce.apply span
    }
    assert sorted(expect) == sorted(LAYER_METRICS)
    for name, value in expect.items():
        got = _metric(name).read(run)
        assert got == (None if value is None else pytest.approx(value)), name


@pytest.mark.parametrize("name", LAYER_METRICS)
def test_layer_metrics_read_nothing_without_layer_spans(name):
    plain = tracing.parse_chrome_trace(_doc())
    assert _metric(name).read(_run(plain)) is None  # the harness's plain parse
    assert _metric(name).read(_run(layers.parse_layer_trace(_doc(program=False)))) is None
    assert _metric(name).read(harness.Run(cell=None, shapes={}, frames_per_fit=1)) is None


@pytest.mark.parametrize(
    "name",
    ["site_grams.roofline_pct", "site_grams_tiled.roofline_pct", "linear_gram.roofline_pct",
     "fit_mfu", "device.idle_pct"],
)
def test_existing_metrics_read_the_same_with_program_spans(name):
    without = tracing.parse_chrome_trace(_doc(program=False))
    with_spans = tracing.parse_chrome_trace(_doc())
    layered = layers.parse_layer_trace(_doc())
    values = [_metric(name).read(_run(t)) for t in (without, with_spans, layered)]
    assert values[0] is not None or name == "site_grams_tiled.roofline_pct"
    assert values[0] == values[1] == values[2]
    assert without.breakdown() == with_spans.breakdown()
    assert layered.breakdown()["device_ops"] == without.breakdown()["device_ops"]


def _label_at(trace, t_us):
    """The label of the idle gap that holds ``t_us``."""
    (label,) = [lab for (s, e), lab in zip(trace.gaps(), trace._gap_labels()) if s < t_us * US < e]
    return label


def test_idle_gap_label_names_the_program_layer():
    tr = layers.parse_layer_trace(_doc())
    assert _label_at(tr, 390) == "bench.fit/aggforce.solve/aten::linalg_cholesky"
    assert _label_at(tr, 615) == "bench.fit/aggforce.entry"
    assert _label_at(tr, 935) == "bench.fit"
    assert _label_at(tracing.parse_chrome_trace(_doc()), 390) == "bench.fit/aten::linalg_cholesky"
    (slow,) = tr.slowest_calls()
    assert slow["span"] == "bench.fit" and slow["seconds"] == pytest.approx(1000 * US)
    assert slow["host_s_by_layer"]["aggforce.solve"] == pytest.approx(400 * US)
    assert slow["longest_idle_gaps"][0] == (pytest.approx(170 * US), "bench.fit/aggforce.entry")
    assert slow["cuda_calls_in_longest_gap"] == [(pytest.approx(5 * US), "cudaLaunchKernel")]


def test_a_traced_cpu_run_records_the_program_layers(tiny_cell, monkeypatch):
    """The harness's traced window, parsed with layers as ``layers.main``
    does: the fit's spans are on the window's thread; with no device
    operation the layer metrics read nothing."""
    seen = {}

    def parse(doc):
        seen["trace"] = layers.parse_layer_trace(doc)
        return seen["trace"]

    monkeypatch.setattr(tracing, "parse_chrome_trace", parse)
    cell = tiny_cell("cln025_ca.feat", True)
    cell.metrics = cell.metrics + harness.load_json(layers.METRICS_FILE)
    out = harness.run_cell(cell, 2**33 + 17, 0.5, True, torch.device("cpu"), lambda m: None)
    names = seen["trace"].layer_names()
    assert {"aggforce.entry", "aggforce.gram", "aggforce.constraints", "aggforce.solve",
            "aggforce.apply"} <= set(names)
    assert not set(LAYER_METRICS) & set(out["metrics"])
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}


def test_the_script_refuses_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="2")
    env.pop("PYTHONPATH", None)
    proc = subprocess.run(
        [sys.executable, str(harness.BENCH_DIR / "layers.py"), "--workload", "cln025_ca.feat",
         "--seed", str(2**40 + 3)],
        cwd=harness.ROOT, env=env, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode != 0
    assert "needs 1 CUDA device" in proc.stderr
