"""The control, the reference solved and applied in TF32 in the program's
place, fails each cell's limits, and the program passes them, at the
cell's own widths on fewer frames (the CPU's size)."""

import copy

import pytest
import torch

from benchmark import harness

# frames per fit (and pool) at which the CPU holds each cell's widths
SIZES = {
    "cln025_ca.feat": 1000,
    "cln025_ca.linear_auto": 2000,
    "solvated_1500.linear": 2000,
}


def _cell(name):
    cell = harness.load_cell(name, False)
    t = SIZES[name]
    traffic = dict(cell.traffic, frames_per_fit=t, pool_frames=2 * t, warm_frames=t)
    return harness.Cell(name, copy.deepcopy(cell.config), traffic, cell.limits, cell.metrics, 1)


def _fails(readings, limits):
    return any(v > limits[k] for k, v in readings.items())


@pytest.mark.parametrize("name", sorted(SIZES))
def test_control_fails_and_program_passes(name):
    cell = _cell(name)
    out = harness.calibration_readings(cell, 2**33 + 1, 1, torch.device("cpu"), True, True)
    assert not _fails(out["program"], cell.limits), out
    assert _fails(out["control"], cell.limits), out


def test_control_fails_the_blocked_cell_at_a_site_block():
    """The solvated featurized cell at its full width K_exp = 9,000 is too
    large for the CPU; its control runs there on a 30-atom cut of the same
    system with the cell's limits."""
    cell = harness.load_cell("solvated_1500.feat_blocked", False)
    cfg = copy.deepcopy(cell.config)
    cfg["system"].update({"n_atoms": 60, "bonded_pairs": {"start": 0, "stop": 30, "step": 2}, "cg_stride": 10})
    traffic = dict(cell.traffic, frames_per_fit=1000, pool_frames=2000, warm_frames=200, check_sites=3)
    cell = harness.Cell(cell.name, cfg, traffic, cell.limits, cell.metrics, 1)
    out = harness.calibration_readings(cell, 2**33 + 2, 1, torch.device("cpu"), True, True)
    assert not _fails(out["program"], cell.limits), out
    assert _fails(out["control"], cell.limits), out
