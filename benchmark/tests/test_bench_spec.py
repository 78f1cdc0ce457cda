"""BENCHMARK.json against the benchmark's files: every name is found."""

import inspect
import json
import re
import subprocess
import sys

import pytest

from benchmark import harness

BENCH = harness.load_json(harness.ROOT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_keys_and_names():
    assert set(BENCH) == {
        "command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer",
    }
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [x["name"] for x in BENCH[group]]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names)
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_cell_found_by_name(cell, trace):
    c = harness.load_cell(cell, trace)
    assert c.config["name"] == cell.split(".")[0]
    assert (harness.BENCH_DIR / "entries" / f"{c.traffic['entry']}.py").exists()
    assert (harness.BENCH_DIR / "checks" / f"{c.traffic['check']}.py").is_file()
    assert callable(c.check.judge) and callable(c.check.work)
    assert c.metrics, "every cell reports metrics in both kinds of run"
    for m in c.metrics:
        mod = harness.load_module(harness.BENCH_DIR / "metrics" / f"{m['name']}.py")
        assert callable(mod.read)
    assert c.limits, f"no limits file for {cell}"
    assert c.chips in (1, 4)
    if c.chips > 1:
        entry = harness.load_module(harness.BENCH_DIR / "entries" / f"{c.traffic['entry']}.py")
        params = list(inspect.signature(entry.prepare).parameters)
        assert params[3:6] == ["rank", "world", "init_url"], params
        assert "ranks_disagree" in c.limits and c.limits["ranks_disagree"] == 0


NO_CHECK = """
import json, sys
sys.path.insert(0, {root!r})
import torch
from benchmark import harness, run, systems

asked = []
read = harness.load_json


def load_json(path):
    out = read(path)
    return dict(out, check="no_such_check") if path.parent.name == "traffic" else out


def note(what):
    def called(*args, **kwargs):
        asked.append(what)
        raise AssertionError(what)
    return called


harness.load_json = load_json
systems.build_system = note("set-up")
torch.cuda.is_available = note("cuda")
torch.cuda.device_count = note("cuda")
try:
    run.main(["--workload", {cell!r}, "--seed", "1", "--seconds", "1"])
except FileNotFoundError as err:
    print(json.dumps({{"error": str(err), "asked": asked}}))
"""


def test_a_check_with_no_file_is_refused_when_the_cell_loads():
    """A traffic whose check has no module fails in ``load_cell``, naming
    the missing file, before the run asks for a card or builds anything."""
    code = NO_CHECK.format(root=str(harness.ROOT), cell=CELLS[0])
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=harness.ROOT, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert "benchmark/checks/no_such_check.py" in out["error"]
    assert out["asked"] == []


def test_four_chip_cells_are_at_most_a_quarter():
    fours = [w["name"] for w in BENCH["workloads"] if w["chips"] == 4]
    assert len(fours) <= max(1, len(CELLS) // 4), fours


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_reports_setup_another_end_to_end_and_a_per_layer_metric(cell):
    e2e = {m["name"] for m in harness.load_cell(cell, False).metrics}
    assert "setup_s" in e2e and len(e2e) >= 2
    per_layer = harness.load_cell(cell, True).metrics
    assert per_layer and all(m["moves"] in e2e for m in per_layer)


def test_configs_keep_the_catalogued_sizes():
    for c in BENCH["configs"]:
        cfg = harness.load_json(harness.ROOT / c["file"])
        assert cfg["reduced"] == c["reduced"] == []
        from benchmark import systems

        shapes = systems.shapes(systems.build_system(cfg), cfg)
        derived = cfg["derived"]
        assert (shapes["G"], shapes["S"], shapes["K_exp"], shapes["R"]) == (
            derived["groups"], derived["sites"], derived["k_exp"], derived["reduced_columns"],
        )
