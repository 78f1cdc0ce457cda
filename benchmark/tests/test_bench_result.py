"""The last line's schema, the refusal without a card and the no-JAX check."""

import json
import os
import subprocess
import sys
import types

import pytest
import torch

from benchmark import harness

RUN = str(harness.BENCH_DIR / "run.py")


def _env():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="2")
    env.pop("PYTHONPATH", None)
    return env


@pytest.mark.parametrize("trace", [False, True])
def test_result_schema(tiny_cell, trace):
    cell = tiny_cell("cln025_ca.feat", trace)
    out = harness.run_cell(cell, 2**33 + 5, 0.5, trace, torch.device("cpu"), lambda m: None)
    keys = list(out)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert keys[-1] == "checks"
    assert isinstance(out["correct"], bool) and out["attempted"] >= 1 and out["failed"] == 0
    assert set(out["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    for name, m in out["metrics"].items():
        assert set(m) == {"value", "unit"} and isinstance(m["value"], float)
    for c in out["checks"].values():
        assert set(c) == {"value", "limit"}
    if trace:
        assert set(out["device"]) >= {"busy_s", "window_s"}
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
        assert all(len(v) <= 10 for v in out["breakdown"].values())
        assert "escalated_sites_per_fit" in out["metrics"]
    else:
        assert set(out["metrics"]) == {m["name"] for m in cell.metrics}
    json.dumps(out)


def test_refuses_without_a_card(tmp_path):
    proc = subprocess.run(
        [sys.executable, RUN, "--workload", "cln025_ca.feat", "--seed", str(2**40 + 3),
         "--seconds", "1", "--trace", "0"],
        cwd=harness.ROOT, env=_env(), capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "needs 1 CUDA device" in proc.stderr


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    assert harness.forbidden_modules() == [] or "jax" in sys.modules
    monkeypatch.setitem(sys.modules, "aggforce_tpu", types.ModuleType("aggforce_tpu"))
    monkeypatch.setitem(sys.modules, "aggforce_tpu.qp", types.ModuleType("aggforce_tpu.qp"))
    found = harness.forbidden_modules()
    assert "aggforce_tpu" in found and "aggforce_tpu.qp" in found
    assert not any(m.split(".")[0] == "aggforce_torch" for m in found)


def test_a_run_loads_no_jax():
    """Every entry's imports and a tiny CPU run of each check leave no JAX,
    Flax or JAX-package module loaded (a fresh process)."""
    code = (
        "import sys, torch; sys.path.insert(0, %r)\n"
        "from benchmark import harness, conftest\n"
        "import copy\n"
        "for name in conftest.TINY:\n"
        "    cell = harness.load_cell(name, False)\n"
        "    if cell.chips > 1:\n"
        "        # its entry's imports here; its runs, one process a rank, in\n"
        "        # test_bench_ranks.py, where every rank looks for JAX itself\n"
        "        harness._entry(cell.traffic); import aggforce_torch.parallel\n"
        "        continue\n"
        "    s, t = conftest.TINY[name]\n"
        "    cfg = copy.deepcopy(cell.config); cfg['system'].update(s)\n"
        "    cell = harness.Cell(name, cfg, dict(cell.traffic, **t), cell.limits, cell.metrics, 1)\n"
        "    harness.run_cell(cell, 3, 0.2, False, torch.device('cpu'), lambda m: None)\n"
        "print(harness.forbidden_modules())\n"
    ) % str(harness.ROOT)
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=harness.ROOT, env=_env(),
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip().splitlines()[-1] == "[]"


def test_planted_jax_package_import_fails_the_run(tmp_path):
    """run.py's own check: a process that has loaded the JAX package after
    its window prints no result (the harness's look for a card stubbed)."""
    code = (
        "import sys, types; sys.path.insert(0, %r)\n"
        "import torch\n"
        "torch.cuda.is_available = lambda: True\n"
        "torch.cuda.device_count = lambda: 1\n"
        "from benchmark import harness, run\n"
        "def fake_run(*a, **k):\n"
        "    sys.modules['aggforce_tpu'] = types.ModuleType('aggforce_tpu')\n"
        "    return {'correct': True, 'checks': {}}\n"
        "harness.run_cell = fake_run\n"
        "run._card_line = lambda: 'stub'\n"
        "sys.exit(run.main(['--workload', 'cln025_ca.feat', '--seed', '1', '--seconds', '1']))\n"
    ) % str(harness.ROOT)
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=harness.ROOT, env=_env(),
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "aggforce_tpu" in proc.stderr
