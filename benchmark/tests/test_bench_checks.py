"""The checks in ``benchmark/checks/``, found by name, read what the
harness's own branches on the check's name read before the checks became
files (commit da7352d), bit for bit.

Each kind judges one fit of a cell at its CPU size (``conftest.TINY``) on
one thread: the program's outputs, the float64 reference and the TF32
control in the program's place, and the program's outputs over the second
of two ranks' shares of the sites. Each check's ``work`` is that commit's
``fit_mfu.flops`` for the shapes of every cell.
"""

import pytest
import torch

from benchmark import harness, systems

SEED = 2**34 + 7
CELLS = [w["name"] for w in harness.load_json(harness.ROOT / "BENCHMARK.json")["workloads"]]
PROGRAM, REFERENCE, CONTROL, SHARE = (
    ("program", "float64", None),
    ("reference", "float64", None),
    ("reference", "tf32", None),
    ("program", "float64", (1, 2)),
)
# readings of fit 1 of SEED at commit da7352d (harness.judge, one thread)
PARENT = {
    "featurized": ("cln025_ca.feat", {
        PROGRAM: {"obj_gap": 3.2478920429539865e-06, "constraint_viol": 1.371123079634933e-08,
                  "apply_err": 1.080361029322351e-06},
        REFERENCE: {"obj_gap": 0.0, "constraint_viol": 4.526606011948269e-10, "apply_err": 0.0},
        CONTROL: {"obj_gap": 0.0008327856055348688, "constraint_viol": 0.00032845715528590197,
                  "apply_err": 0.0033559088524567214},
        SHARE: {"obj_gap": -1.74924977390847e-09, "constraint_viol": 5.987436263465399e-09,
                "apply_err": 9.418345424716536e-07},
    }),
    "linear": ("solvated_1500.linear", {
        PROGRAM: {"force_rel_rms": 3.1413984093351896e-07, "orth_viol": 9.947598300641403e-14,
                  "apply_err": 1.16479097658434e-06},
        REFERENCE: {"force_rel_rms": 0.0, "orth_viol": 1.4432899320127035e-15, "apply_err": 0.0},
        CONTROL: {"force_rel_rms": 0.0004927311717666593, "orth_viol": 0.0005494952201843262,
                  "apply_err": 0.0028184746746544704},
        SHARE: {"force_rel_rms": 3.1413984093351896e-07, "orth_viol": 9.947598300641403e-14,
                "apply_err": 1.16479097658434e-06},
    }),
    "linear_detect": ("cln025_ca.linear_auto", {
        PROGRAM: {"mismatched_pairs": 0.0, "force_rel_rms": 2.9279340386863544e-07,
                  "orth_viol": 1.3145040611561853e-13, "apply_err": 8.771489616867317e-07},
        REFERENCE: {"mismatched_pairs": 0.0, "force_rel_rms": 0.0, "orth_viol": 5.551115123125783e-16,
                    "apply_err": 0.0},
        CONTROL: {"mismatched_pairs": 0.0, "force_rel_rms": 0.0003905536744208598,
                  "orth_viol": 0.0003632970619946718, "apply_err": 0.002611780976479935},
        SHARE: {"mismatched_pairs": 0.0, "force_rel_rms": 2.9279340386863544e-07,
                "orth_viol": 1.3145040611561853e-13, "apply_err": 8.771489616867317e-07},
    }),
}


def _parent_flops(shapes, t, kind):
    """``fit_mfu.flops`` at commit da7352d."""
    if kind == "featurized":
        k = shapes["K_exp"]
        return 3.0 * t * shapes["S"] * k * (k + 1)
    r = shapes["R"]
    return 3.0 * t * r * (r + 1)


@pytest.fixture
def one_thread():
    """The featurized readings depend on the CPU's summation order."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("kind", sorted(PARENT))
def test_check_reads_as_the_parent_did(tiny_cell, one_thread, kind):
    name, expect = PARENT[kind]
    cell = tiny_cell(name)
    assert cell.traffic["check"] == kind
    ses = harness.Session(cell, SEED, torch.device("cpu"))
    item = ses.fit(1)
    ses.release()
    got = {mode: cell.check.judge(ses, item, *mode) for mode in expect}
    assert got == expect
    # and through the harness's lookup, each beside its limit
    checks = harness.check_outputs(ses, [item], "program")
    assert {k: c["value"] for k, c in checks.items()} == expect[PROGRAM]
    assert all(c["limit"] == cell.limits[k] for k, c in checks.items())


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("kind", sorted(PARENT))
def test_work_is_the_parent_count(cell, kind):
    c = harness.load_cell(cell, False)
    shapes = systems.shapes(systems.build_system(c.config), c.config)
    t = int(c.traffic["frames_per_fit"])
    assert harness.load_check(kind).work(shapes, t) == _parent_flops(shapes, t, kind)
