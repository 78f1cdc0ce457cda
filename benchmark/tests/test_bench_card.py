"""On the card: a short run of each cell is correct and its result carries
the fields a result line must carry. Skips without as many NVIDIA GPUs as
the cell's chips."""

import json
import subprocess
import sys

import pytest
import torch

from benchmark import harness

BENCH = harness.load_json(harness.ROOT / "BENCHMARK.json")


@pytest.mark.card
@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_short_run_on_the_card(cell):
    chips = harness.load_cell(cell, False).chips
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        pytest.skip(f"needs {chips} NVIDIA GPU(s)")
    proc = subprocess.run(
        [sys.executable, str(harness.BENCH_DIR / "run.py"), "--workload", cell,
         "--seed", str(2**33 + 99), "--seconds", "3", "--trace", "0"],
        cwd=harness.ROOT, capture_output=True, text=True, timeout=900,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["correct"], out["checks"]
    assert out["device"]["platform"] == "gpu" and out["device"]["count"] == chips
