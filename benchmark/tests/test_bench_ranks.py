"""A cell on several chips through run.py's launcher, on the CPU: one gloo
rank per process, the look for cards skipped, the mesh cell at its CPU size
(``conftest.TINY``) with its own limits.

A sound run prints one result line with ``device.count`` equal to the
ranks and reads ``correct`` true. Each fault the cell can have, planted on
every rank, reads ``correct`` false: a fit that returns its first map
unchanged, half of the frames left out of the Gram (the mean taken over
the rest), the exchange between the ranks left out (each rank's gather
returns its own part in every rank's place), and the mapped forces 1%
too large where they are produced (the cell's ``apply_err`` limit, 2e-2,
lets 0.1% pass: at 100,000 frames the program itself reads 8.3e-4 and its
TF32 control 0.45); so do rank 0's coefficients of rank 1's
sites zeroed on rank 0 alone. A rank killed in the window ends the run at
once with a code other than 0 and no result, and so does the JAX package
loaded in one rank's process alone: each rank looks for it once the window
has closed, so a sound run exits 0 only when no rank has loaded it.
"""

import json
import os
import subprocess
import sys
import time

import pytest
import torch

from benchmark import harness

MESH = "solvated_1500.feat_blocked.mesh4"
RUN = str(harness.BENCH_DIR / "run.py")

WRAPPER = """
import copy, os, signal, sys
sys.path.insert(0, {root!r})
from benchmark import conftest, harness, run

WORLD, FAULT = {world!r}, {fault!r}
RANK = int(sys.argv[sys.argv.index("--rank") + 1]) if "--rank" in sys.argv else 0
load_cell, entry = harness.load_cell, harness._entry


def tiny(name, trace):
    cell = load_cell(name, trace)
    s, t = conftest.TINY[name]
    cfg = copy.deepcopy(cell.config)
    cfg["system"].update(s)
    cfg["featurizer"]["n_basis"] = 3
    return harness.Cell(name, cfg, dict(cell.traffic, **t), cell.limits, cell.metrics, WORLD)


def faulty(traffic):
    mod = entry(traffic)
    fit = mod.fit
    calls = []

    def zero_rank1_sites(state, *args):
        out = fit(state, *args)
        if RANK == 0:
            sb, n = state["site_block"], len(out["coefs"])
            for s0 in range(0, n, sb * WORLD):
                for s in range(s0 + sb, min(s0 + 2 * sb, n)):
                    out["coefs"][s] = out["coefs"][s] * 0.0
        return out

    def killed(state, *args):
        calls.append(1)
        if RANK == 1 and len(calls) == 3:
            os.kill(os.getpid(), signal.SIGKILL)
        return fit(state, *args)

    mod.fit = {{"zero_rank1_sites": zero_rank1_sites, "killed": killed}}.get(FAULT, fit)
    return mod


def plant():
    # the faults that break the program underneath, on every rank
    import torch
    import aggforce_torch.qp as qp
    from aggforce_torch.parallel import mesh
    from aggforce_torch.qp import fusedfeat

    if FAULT == "jax_on_rank0" and RANK == 0 or FAULT == "jax_on_rank1" and RANK == 1:
        import types
        sys.modules["aggforce_tpu"] = types.ModuleType("aggforce_tpu")
    elif FAULT == "stale":
        original, first = qp.fused_gb_linear_map_blocked, []

        def stale(*args, **kwargs):
            if not first:
                first.append(original(*args, **kwargs))
            return first[0]

        qp.fused_gb_linear_map_blocked = stale
    elif FAULT == "half_frames":
        original = fusedfeat._site_gram

        def half(coords, forces, mask, *rest, **kw):
            keep = mask.clone()
            keep[1::2] = 0.0
            return 2.0 * original(coords, forces, keep, *rest, **kw)

        fusedfeat._site_gram = half
    elif FAULT == "no_exchange":
        mesh.FrameMesh.all_gather = lambda self, x: torch.cat([x.contiguous()] * self.size)
    elif FAULT == "altered":
        original = fusedfeat._fused_apply
        fusedfeat._fused_apply = lambda *a, **k: original(*a, **k) * 1.01


plant()
harness.load_cell = tiny
harness._entry = faulty
run.cell_chips = lambda name: WORLD
run.DEVICE_TYPE = "cpu"
sys.exit(run.main(sys.argv[1:]))
"""


def _env():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    env.pop("PYTHONPATH", None)
    return env


def _launch(tmp_path, world, fault=None, seconds=0.8, seed=2**33 + 17, trace=0):
    script = tmp_path / "wrapped_run.py"
    script.write_text(WRAPPER.format(root=str(harness.ROOT), world=world, fault=fault))
    t0 = time.monotonic()
    proc = subprocess.run(
        [sys.executable, str(script), "--workload", MESH, "--seed", str(seed),
         "--seconds", str(seconds), "--trace", str(trace)],
        cwd=tmp_path, env=_env(), capture_output=True, text=True, timeout=240,
    )
    return proc, time.monotonic() - t0


@pytest.mark.parametrize("world", [2, 4])
def test_mesh_cell_through_the_launcher(tmp_path, world):
    proc, _ = _launch(tmp_path, world)
    assert proc.returncode == 0, proc.stderr[-4000:]
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
    assert len(lines) == 1, proc.stdout
    out = json.loads(lines[0])
    assert out["correct"], out["checks"]
    assert out["device"]["count"] == world
    assert out["checks"]["ranks_disagree"] == {"value": 0.0, "limit": 0}
    assert set(out["metrics"]) == {"frames_per_s", "setup_s"}
    for r in range(1, world):
        assert f"[rank {r}]" in proc.stderr
    # the check lines are the last lines of standard error
    assert proc.stderr.strip().splitlines()[-1].startswith("check ranks_disagree:")


def test_traced_mesh_run_reports_rank_0s_trace(tmp_path):
    proc, _ = _launch(tmp_path, 2, trace=1)
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["correct"], out["checks"]
    assert out["attempted"] == 2  # the traffic's traced_fits, on every rank
    assert {"busy_s", "window_s"} <= set(out["device"])
    assert "escalated_sites_per_fit" in out["metrics"]


@pytest.mark.parametrize("fault", ["stale", "half_frames", "no_exchange", "altered"])
def test_fault_makes_the_mesh_run_incorrect(tmp_path, fault):
    proc, _ = _launch(tmp_path, 2, fault=fault)
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert not out["correct"], out["checks"]


def test_rank_1s_sites_zeroed_on_rank_0_read_incorrect(tmp_path):
    proc, _ = _launch(tmp_path, 2, fault="zero_rank1_sites")
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert not out["correct"], out["checks"]
    assert out["checks"]["ranks_disagree"]["value"] == 1.0


def test_a_killed_rank_ends_the_run(tmp_path):
    proc, seconds = _launch(tmp_path, 4, fault="killed", seconds=120)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert seconds < 60, seconds


@pytest.mark.parametrize("rank", [0, 1])
def test_jax_loaded_on_one_rank_refuses_the_run(tmp_path, rank):
    proc, _ = _launch(tmp_path, 2, fault=f"jax_on_rank{rank}")
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "forbidden modules loaded: ['aggforce_tpu']" in proc.stderr, proc.stderr[-4000:]


def test_mesh_cell_refuses_without_cards():
    proc = subprocess.run(
        [sys.executable, RUN, "--workload", MESH, "--seed", str(2**40 + 5),
         "--seconds", "1", "--trace", "0"],
        cwd=harness.ROOT, env=_env(), capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "needs 4 CUDA device" in proc.stderr


def test_control_fails_the_mesh_cells_limits():
    """The reference solved and applied in TF32, in the program's place,
    fails the mesh cell's limits (the cell's widths on a 60-atom cut of its
    system and 1,000 frames; the program's side is the sound runs above)."""
    cell = harness.load_cell(MESH, False)
    cfg = dict(cell.config, system=dict(cell.config["system"], n_atoms=60,
                                        bonded_pairs={"start": 0, "stop": 30, "step": 2}, cg_stride=10))
    traffic = dict(cell.traffic, frames_per_fit=1000, pool_frames=2000, check_sites=3)
    cell = harness.Cell(cell.name, cfg, traffic, cell.limits, cell.metrics, cell.chips)
    out = harness.calibration_readings(cell, 2**33 + 3, 1, torch.device("cpu"), False, True)
    assert any(v > cell.limits[k] for k, v in out["control"].items()), out
