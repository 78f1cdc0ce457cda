"""The path the mesh cell times, on the CPU: ``fused_gb_linear_map_blocked``
over four gloo ranks (one process each), at a size where the last step of
site blocks leaves two ranks only padding (S = 11, ``site_block`` 2: steps
of 8 sites, the second holds 3).

The ranks agree bit for bit; their coefficients are the one-device fit's
(each block holds the same sites on both paths, so each block's Gram and
solve are the same computation) and so is ``escalated``; and the objective
lies within ``OBJ_TOL`` of the float64 reference's optimum
(``benchmark/reference/featurized.py``), the cell's own limit.
"""

import copy
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark import harness, systems
from benchmark.reference import featurized

WORLD = 4
SEED = 2**33 + 29
FRAMES = 400
# the cell's limit of the objective gap: the fit's float32 Gram and float32
# solve (with its fixed ridge of 1e-6 of the mean diagonal) against the
# float64 optimum; the gap reads 2.1e-4 at this size
OBJ_TOL = harness.load_cell("solvated_1500.feat_blocked.mesh4", False).limits["obj_gap"]

WORKER = """
import sys
import numpy as np
sys.path.insert(0, {root!r})
from benchmark.tests import test_bench_mesh as t
from aggforce_torch import parallel
if sys.argv[1] == "one":
    np.savez({out!r} + "/one.npz", **t.fit())
else:
    rank = int(sys.argv[1])
    parallel.initialize_distributed({url!r}, {world}, rank, backend="gloo")
    out = t.fit(parallel.make_mesh(device="cpu"))
    np.savez({out!r} + f"/rank{{rank}}.npz", **out)
"""


def config():
    cfg = copy.deepcopy(harness.load_cell("solvated_1500.feat_blocked.mesh4", False).config)
    cfg["system"].update({"n_atoms": 55, "bonded_pairs": {"start": 0, "stop": 20, "step": 2}, "cg_stride": 5})
    cfg["featurizer"]["n_basis"] = 3
    cfg["site_block"] = 2
    return cfg


def problem():
    cfg = config()
    system = systems.build_system(cfg)
    coords, forces = systems.make_pool(system, FRAMES, SEED, torch.device("cpu"))
    return cfg, system, coords, forces


def fit(mesh=None):
    """The blocked fit of :func:`problem` as the mesh cell's entry calls it
    (over ``mesh``, or on one device): coefficients and ``escalated``."""
    import aggforce_torch as agg
    from aggforce_torch.qp import fused_gb_linear_map_blocked
    from aggforce_torch.qp.fusedfeat import GBFeatSpec

    cfg, system, coords, forces = problem()
    spec = cfg["featurizer"]
    tmap = fused_gb_linear_map_blocked(
        agg.Trajectory(coords=coords, forces=forces),
        agg.LinearMap([[s] for s in system.sites], n_fg_sites=system.n_atoms),
        kbt=system.kbt,
        spec=GBFeatSpec(
            outer=spec["outer"], inner=spec["inner"], n_basis=spec["n_basis"],
            width=spec["width"], dist_power=spec["dist_power"], clip=spec["clip"],
        ),
        constraints={frozenset(p) for p in system.pairs},
        n_constraint_frames=cfg["n_constraint_frames"],
        l2_regularization=cfg["l2_regularization"], chunk_size=cfg["chunk_size"],
        constraint_rng=np.random.default_rng(SEED), site_block=cfg["site_block"],
        mesh=mesh, device="cpu",
    )
    tags = tmap.force_map.tags
    return {"coefs": np.stack(tags["coef_list"]), "escalated": np.array(tags["escalated"])}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each rank's fit, and the one-device fit last, each in a process of
    its own on one thread (the CPU's float32 products and numpy's LAPACK sum
    in an order that follows the thread count)."""
    tmp = tmp_path_factory.mktemp("mesh")
    code = WORKER.format(root=str(harness.ROOT), url=f"file://{tmp}/group", world=WORLD, out=str(tmp))
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    procs = [
        subprocess.Popen([sys.executable, "-c", code, r], env=env, cwd=tmp,
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in [*map(str, range(WORLD)), "one"]
    ]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=180)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)[-4000:]
    return [dict(np.load(tmp / f"{name}.npz")) for name in [*(f"rank{r}" for r in range(WORLD)), "one"]]


def test_the_last_step_leaves_two_ranks_only_padding():
    s_all, sb = 11, config()["site_block"]
    assert len(systems.build_system(config()).sites) == s_all
    last = s_all - (s_all // (sb * WORLD)) * sb * WORLD
    assert -(-last // sb) == WORLD - 2


def test_ranks_agree_bit_for_bit(runs):
    ranks = runs[:WORLD]
    for r in range(1, WORLD):
        assert np.array_equal(ranks[r]["coefs"], ranks[0]["coefs"])
        assert ranks[r]["escalated"] == ranks[0]["escalated"]


def test_ranks_match_the_one_device_fit(runs):
    ranks, one = runs[:WORLD], runs[WORLD]
    np.testing.assert_array_equal(ranks[0]["coefs"], one["coefs"])
    assert ranks[0]["escalated"] == one["escalated"]


def test_objective_near_the_float64_reference(runs):
    cfg, system, coords, forces = problem()
    frames = np.random.default_rng(SEED).choice(FRAMES, size=cfg["n_constraint_frames"], replace=False)
    sites = list(range(len(system.sites)))
    coefs = torch.as_tensor(runs[0]["coefs"], dtype=torch.float64)
    # the mapped forces are not judged here: the reference's own stand in
    x_ref = featurized.check_fit(system, cfg, coords, forces, frames, sites, None, None, "float64")
    out = featurized.check_fit(
        system, cfg, coords, forces, frames, sites, coefs, torch.zeros((FRAMES, len(sites), 3)), "float64",
    )
    assert abs(x_ref["obj_gap"]) < 1e-9
    assert out["obj_gap"] < OBJ_TOL, out
    assert out["constraint_viol"] < 1e-4, out
