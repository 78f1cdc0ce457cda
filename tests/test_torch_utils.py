"""The port's run-time utilities: profiling, debug mode, warm-up, the device
constant cache, the kernels' build directory and lock, and the alias
modules, held against the JAX package's where the two compute alike."""

import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import aggforce_torch as pt
from aggforce_torch.qp.fusedfeat import GBFeatSpec, fused_gb_linear_map
from aggforce_torch.utils import devcache
from aggforce_torch.utils.debug import check_finite, debug_mode
from aggforce_torch.utils.prof import PhaseTimer, device_peaks, trace
from aggforce_torch.utils.warmup import (
    WarmupHandle,
    warm_featurized_batch,
    warm_featurized_fit,
    warm_gauss_fit,
    warm_linear_fit,
)

REPO_ROOT = Path(__file__).resolve().parent.parent


def _system():
    rng = np.random.default_rng(3)
    cmap = pt.LinearMap([[0], [4], [8]], n_fg_sites=12)
    constraints = {frozenset({1, 2}), frozenset({5, 6})}
    coords = rng.normal(size=(64, 12, 3)).astype(np.float32)
    forces = rng.normal(size=(64, 12, 3)).astype(np.float32)
    return cmap, constraints, coords, forces


# --- prof ---------------------------------------------------------------------


def test_phase_timer_accumulates_and_reports():
    timer = PhaseTimer()
    for _ in range(2):
        with timer.phase("sleep"):
            time.sleep(0.01)
    with timer.phase("other"):
        pass
    assert timer.total("sleep") >= 0.02
    assert [name for name, _ in timer.records] == ["sleep", "sleep", "other"]
    report = timer.report().splitlines()
    assert report[0] == "phase timings:" and "sleep" in report[1] and "(x2)" in report[1]
    assert timer.total("missing") == 0.0


def test_device_peaks_is_none_without_a_card():
    assert device_peaks("cpu") is None
    if not torch.cuda.is_available():
        assert device_peaks() is None


def test_trace_writes_a_chrome_trace(tmp_path):
    """The trace holds the host's activity with the program's layer spans
    over the operators they ran (here a map's apply)."""
    fmap = pt.TLinearMap([[0], [1, 2]], n_fg_sites=3, device="cpu")
    with trace(str(tmp_path / "tr")) as logdir:
        fmap(torch.ones(4, 3, 3))
    path = Path(logdir) / "trace.json"
    assert path.exists()
    events = json.loads(path.read_text())["traceEvents"]
    (apply,) = [e for e in events if e.get("name") == "aggforce.apply"]
    assert apply["cat"] == "user_annotation"
    t0, t1 = apply["ts"], apply["ts"] + apply["dur"]
    assert any(
        e.get("cat") == "cpu_op" and t0 <= e["ts"] and e["ts"] + e["dur"] <= t1
        for e in events
    )


# --- debug --------------------------------------------------------------------


def test_debug_mode_raises_on_a_planted_nan():
    with debug_mode():
        torch.ones(3) / 2  # finite: silent
        torch.empty(16)  # uninitialized memory is not a computed value
        with pytest.raises(FloatingPointError, match="NaN in the output of aten.log"):
            torch.log(torch.tensor([-1.0]))
    assert torch.isnan(torch.log(torch.tensor([-1.0]))).all()  # off again


def test_debug_mode_infs_only_when_asked():
    with debug_mode():
        torch.tensor([1.0]) / 0.0
    with debug_mode(infs=True):
        with pytest.raises(FloatingPointError, match="Inf"):
            torch.tensor([1.0]) / 0.0


def test_debug_mode_is_silent_on_a_fit():
    cmap, constraints, coords, forces = _system()
    with debug_mode():
        tmap = fused_gb_linear_map(
            pt.Trajectory(coords=coords, forces=forces), cmap, kbt=0.7,
            spec=GBFeatSpec(outer=2.0, n_basis=3), constraints=constraints,
            l2_regularization=1e3, constraint_rng=np.random.default_rng(0), device="cpu",
        )
    assert np.isfinite(np.stack(tmap.force_map.tags["coef_list"])).all()


def test_check_finite_guards_kernel_outputs():
    """The ctypes kernels bypass dispatch: their wrappers call check_finite,
    which trips only inside a debug mode."""
    bad = torch.tensor([1.0, float("nan")])
    check_finite("site_grams", bad)  # off: silent
    with debug_mode():
        check_finite("site_grams", torch.ones(2))
        with pytest.raises(FloatingPointError, match="NaN in the output of site_grams"):
            check_finite("site_grams", bad)


def test_debug_environment_variable():
    code = (
        "import torch, aggforce_torch.utils.debug\n"
        "try:\n    torch.log(torch.tensor([-1.0]))\nexcept FloatingPointError:\n"
        "    print('raised')\n"
    )
    env = dict(os.environ, AGGFORCE_DEBUG="1")
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO_ROOT, env=env, capture_output=True,
        text=True, timeout=120,
    )
    assert out.stdout.strip() == "raised", out.stderr


# --- warmup -------------------------------------------------------------------


def test_warm_featurized_fit_completes_and_records_phases():
    cmap, constraints, coords, forces = _system()
    spec = GBFeatSpec(outer=2.0, n_basis=3)
    handle = warm_featurized_fit(64, cmap, spec, constraints, chunk_size=32, device="cpu")
    assert handle.wait(timeout=120) >= 0.0 and handle.done
    assert handle.error is None, handle.error
    assert handle.elapsed > 0.0 and set(handle.phases) == {"synth", "fit"}
    tmap = fused_gb_linear_map(
        pt.Trajectory(coords=coords, forces=forces), cmap, kbt=0.7, spec=spec,
        constraints=constraints, chunk_size=32, constraint_rng=np.random.default_rng(0),
        device="cpu",
    )
    assert np.all(np.isfinite(tmap.map_arrays(coords[:8], forces[:8])[1]))


def test_warm_linear_gauss_and_batch_handles():
    cmap, constraints, _, _ = _system()
    handles = [
        warm_linear_fit(64, cmap, constraints, device="cpu"),
        warm_gauss_fit(64, cmap, var=0.1, constraints=constraints, device="cpu"),
        warm_featurized_batch(
            64, cmap, GBFeatSpec(outer=2.0, n_basis=3), constraints, batch=4, device="cpu"
        ),
    ]
    for h in handles:
        h.wait(timeout=120)
        assert h.done and h.error is None, (h.label, h.error)


def test_warmup_errors_are_recorded_not_raised():
    handle = warm_linear_fit(8, object(), device="cpu")
    assert handle.wait(timeout=60) >= 0.0
    assert handle.done and isinstance(handle.error, AttributeError)


def test_warmup_target_must_take_the_phases_dict():
    with pytest.raises(TypeError, match="phases dict"):
        WarmupHandle(lambda: None, "bad")
    seen = {}
    handle = WarmupHandle(lambda phases: phases.update(step=1.0) or seen.update(ran=True), "ok")
    handle.wait(timeout=60)
    assert seen == {"ran": True} and handle.phases == {"step": 1.0}


def test_warm_featurized_fit_mesh_raises():
    """``mesh`` is checked at the call (not a mesh: TypeError, before any
    thread starts), and a one-rank mesh warm-up runs its mesh fit."""
    from aggforce_torch.parallel import initialize_distributed, make_mesh

    cmap, constraints, _, _ = _system()
    spec = GBFeatSpec(outer=2.0, n_basis=3)
    with pytest.raises(TypeError, match="FrameMesh"):
        warm_featurized_fit(64, cmap, spec, constraints, mesh=object(), device="cpu")
    initialize_distributed(backend="gloo")
    try:
        handle = warm_featurized_fit(
            64, cmap, spec, constraints, mesh=make_mesh(device="cpu"), device="cpu"
        )
        handle.wait(timeout=120)
    finally:
        torch.distributed.destroy_process_group()
    assert handle.done and handle.error is None and handle.phases["fit"] > 0


# --- devcache -----------------------------------------------------------------


@pytest.fixture()
def clean_cache():
    devcache._CONST_CACHE.clear()
    devcache._SCALAR_CACHE.clear()
    yield
    devcache._CONST_CACHE.clear()
    devcache._SCALAR_CACHE.clear()


def test_device_const_content_hit(clean_cache):
    a = np.arange(12, dtype=np.float32).reshape(3, 4)
    d1 = devcache.device_const(a, device="cpu")
    d2 = devcache.device_const(a.copy(), device="cpu")
    assert d1 is d2
    np.testing.assert_array_equal(d1.numpy(), a)
    a[0, 0] = 99.0  # the cache holds a copy, not the caller's memory
    assert d1[0, 0] == 0.0


def test_device_const_miss_on_change_and_dtype(clean_cache):
    a = np.ones((2, 2), dtype=np.float32)
    d1 = devcache.device_const(a, device="cpu")
    b = a.copy()
    b[0, 0] = 7.0
    d2 = devcache.device_const(b, device="cpu")
    assert d1 is not d2 and float(d2[0, 0]) == 7.0
    ints = devcache.device_const(np.ones(3), dtype=np.int32, device="cpu")
    assert ints.dtype == torch.int32
    assert devcache.device_const(np.ones(3), dtype=np.float32, device="cpu").dtype == torch.float32


def test_device_const_in_place_write_is_not_served(clean_cache):
    """torch tensors are mutable: a cached tensor written in place is
    dropped on the next hit and uploaded anew."""
    a = np.full(4, 2.0, dtype=np.float32)
    d1 = devcache.device_const(a, device="cpu")
    d1.mul_(10.0)
    d2 = devcache.device_const(a, device="cpu")
    assert d2 is not d1
    np.testing.assert_array_equal(d2.numpy(), a)
    assert devcache.device_const(a, device="cpu") is d2
    s1 = devcache.device_scalar(3.0, device="cpu")
    s1.add_(1.0)
    assert float(devcache.device_scalar(3.0, device="cpu")) == 3.0


def test_device_const_lru_bound(clean_cache):
    for i in range(devcache._CONST_CACHE_MAX + 5):
        devcache.device_const(np.full(4, i, dtype=np.float32), device="cpu")
    assert len(devcache._CONST_CACHE) == devcache._CONST_CACHE_MAX
    # the newest entry is still served from the cache
    newest = np.full(4, devcache._CONST_CACHE_MAX + 4, dtype=np.float32)
    assert devcache.device_const(newest, device="cpu") is devcache.device_const(
        newest, device="cpu"
    )


def test_device_const_byte_cap_evicts_lru(clean_cache, monkeypatch):
    monkeypatch.setattr(devcache, "_CONST_CACHE_MAX_BYTES", 3 * 4096 * 4)
    keep = [np.full(4096, i, dtype=np.float32) for i in range(5)]
    for arr in keep:
        devcache.device_const(arr, device="cpu")
    assert len(devcache._CONST_CACHE) == 3


def test_device_scalar_hit_and_value(clean_cache):
    s1 = devcache.device_scalar(1e3, device="cpu")
    assert devcache.device_scalar(1000.0, device="cpu") is s1
    assert float(s1) == 1000.0 and s1.dtype == torch.float32
    assert devcache.device_scalar(1e3, dtype=torch.float64, device="cpu") is not s1


# --- the kernels' build directory and lock ------------------------------------


def test_enable_compile_cache_resolution(tmp_path, monkeypatch):
    from aggforce_torch.ops import _build
    from aggforce_torch.utils.cache import enable_compile_cache

    default = _build.BUILD_DIR
    assert default == REPO_ROOT / "aggforce_torch" / "_build"
    monkeypatch.setattr(_build, "BUILD_DIR", default)
    monkeypatch.delenv("AGGFORCE_COMPILE_CACHE", raising=False)
    assert enable_compile_cache() == str(default.resolve())
    monkeypatch.setenv("AGGFORCE_COMPILE_CACHE", str(tmp_path / "env"))
    assert enable_compile_cache() == str((tmp_path / "env").resolve())
    assert _build.library_path("site_grams.cu").parent == (tmp_path / "env").resolve()
    explicit = enable_compile_cache(str(tmp_path / "arg"))
    assert explicit == str((tmp_path / "arg").resolve()) and (tmp_path / "arg").is_dir()


def test_build_all_runs_one_nvcc_per_source_across_threads(tmp_path, monkeypatch):
    """A warm-up thread and the main thread building at once start one
    compile per source between them."""
    from aggforce_torch.ops import _build

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc")
    launched = []
    lock = threading.Lock()

    class FakeNvcc:
        def __init__(self, cmd, **kwargs):
            with lock:
                launched.append(cmd[-1])
            self.out = cmd[cmd.index("-o") + 1]
            self.returncode = 0

        def communicate(self):
            time.sleep(0.05)  # a compile long enough for the threads to meet
            Path(self.out).write_bytes(b"")
            return "ptxas info", None

    monkeypatch.setattr(_build.subprocess, "Popen", FakeNvcc)
    results = []
    threads = [
        threading.Thread(target=lambda: results.append(_build.build_all()))
        for _ in range(4)
    ]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert sorted(Path(p).name for p in launched) == sorted(_build.SOURCES)
    assert len(results) == 4 and all(r == results[0] for r in results)
    assert all(lib.exists() for lib in results[0].values())


# --- alias modules --------------------------------------------------------------


def test_alias_modules_match_the_jax_package():
    import aggforce_tpu.jaxutil as jaxutil
    import aggforce_tpu.util as jutil

    from aggforce_torch import torchutil, util

    assert util.trjdot is pt.ops.core.trjdot and util.Curry is pt.Curry
    assert {n for n in dir(jutil) if not n.startswith("_")} - {"ops", "utils"} <= set(dir(util))
    assert {n for n in dir(jaxutil) if not n.startswith("_")} - {"ops"} <= set(dir(torchutil))
    rng = np.random.default_rng(0)
    pts = rng.normal(size=(5, 6, 3)).astype(np.float32)
    np.testing.assert_allclose(
        torchutil.distances(torch.as_tensor(pts)).numpy(),
        np.asarray(jaxutil.distances(pts)), rtol=1e-5, atol=1e-6,
    )
    np.testing.assert_allclose(util.distances(pts), jutil.distances(pts), rtol=1e-6)
