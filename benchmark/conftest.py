"""Test settings of the benchmark's own tests (``benchmark/tests``).

They run on the CPU. Tests marked ``card`` need an NVIDIA GPU: each decides
inside itself whether one is there and skips if not. Run them on the card
with ``python3 -m pytest benchmark/tests -m card``.
"""

import copy

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA GPU (skips without one)")


# each cell cut to a size the CPU runs in about a second: fewer atoms,
# frames and basis functions; everything else as configured
TINY = {
    "cln025_ca.feat": (
        {"n_atoms": 40, "bonded_pairs": {"start": 0, "stop": 10, "step": 2}, "cg_stride": 8},
        {"pool_frames": 1500, "frames_per_fit": 300, "warm_frames": 300, "traced_fits": 3},
    ),
    "solvated_1500.feat_blocked": (
        {"n_atoms": 60, "bonded_pairs": {"start": 0, "stop": 20, "step": 2}, "cg_stride": 7},
        {"pool_frames": 1500, "frames_per_fit": 300, "warm_frames": 100, "traced_fits": 2, "check_sites": 4},
    ),
    "cln025_ca.linear_auto": (
        {"n_atoms": 40, "bonded_pairs": {"start": 0, "stop": 10, "step": 2}, "cg_stride": 8},
        {"pool_frames": 1500, "frames_per_fit": 300, "warm_frames": 300, "traced_fits": 3},
    ),
    "solvated_1500.feat_blocked.mesh4": (
        {"n_atoms": 60, "bonded_pairs": {"start": 0, "stop": 20, "step": 2}, "cg_stride": 7},
        {"pool_frames": 1500, "frames_per_fit": 300, "warm_frames": 100, "traced_fits": 2, "check_sites": 4},
    ),
    "solvated_1500.linear": (
        {"n_atoms": 60, "bonded_pairs": {"start": 0, "stop": 20, "step": 2}, "cg_stride": 7},
        {"pool_frames": 1500, "frames_per_fit": 300, "warm_frames": 300, "traced_fits": 3},
    ),
}


@pytest.fixture
def tiny_cell():
    """``make(name, trace)``: the cell of ``BENCHMARK.json`` at a CPU size,
    with the cell's own limits."""
    from benchmark import harness

    def make(name: str, trace: bool = False):
        cell = harness.load_cell(name, trace)
        sys_cut, traffic_cut = TINY[name]
        cfg = copy.deepcopy(cell.config)
        cfg["system"].update(sys_cut)
        if "featurizer" in cfg:
            cfg["featurizer"]["n_basis"] = 3
        traffic = dict(cell.traffic, **traffic_cut)
        return harness.Cell(name, cfg, traffic, cell.limits, cell.metrics, cell.chips)

    return make
