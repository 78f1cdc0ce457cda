"""Smoke tests of the port's examples: each ``--demo`` runs two gloo
processes on the CPU at a tiny size and must end with its OK line."""

import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent


def _run(script: str, *args: str) -> subprocess.CompletedProcess:
    # one thread per demo process: the suite runs beside other test workers
    env = dict(os.environ, OMP_NUM_THREADS="1")
    for key in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        env.pop(key, None)
    return subprocess.run(
        [sys.executable, str(REPO / "examples" / script), *args],
        capture_output=True, text=True, timeout=300, env=env, cwd=str(REPO),
    )


@pytest.mark.parametrize(
    "script, args, ok",
    [
        ("torch_sharded.py", ("--demo", "--frames", "300", "--atoms", "30"), "sharded demo OK"),
        ("torch_multihost_sweep.py", ("--demo",), "multihost sweep demo OK"),
    ],
    ids=["sharded", "multihost_sweep"],
)
def test_example_demo(script, args, ok):
    proc = _run(script, *args)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    assert ok in proc.stdout
