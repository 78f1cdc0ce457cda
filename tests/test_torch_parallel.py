"""Port parity: the mesh fits on two gloo ranks against each other, against
the port's single-device fits and against the JAX package's mesh fits.

Two worker processes join one gloo group on a FileStore in a temporary
directory (no port, nothing shared between test workers), run every mesh
entry point of the port on the CPU and write their results to .npz files.
The inputs are made here with numpy from a seed, at sizes no mesh size
divides: 203 frames, 10 cg sites, 5 batch fits. The JAX side runs on a
2-device slice of the virtual CPU mesh (conftest.py sets 8 devices).

Tolerances: the two ranks' maps are equal bit for bit. Against the
single-device port and the JAX mesh fits the tests take the JAX mesh tests'
own (tests/test_parallel.py): linear map atol 2e-4 (:46); featurized mapped
forces 2e-3 * mean|f| (:85, :118, the port's fit-level bound); batch
2e-3 * max|f| (:290); shared-factor solve rtol 2e-4, atol 2e-5 (:324-328);
force smoothness rtol 1e-5; the staged Gaussian premap atol 5e-5 (:404).
CV scores take the single-device port tests' 1e-4 relative
(tests/test_torch_cv.py), on a well-regularized grid.
"""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import aggforce_torch as pt
from aggforce_torch.ops import eqp as peqp
from aggforce_torch.qp import cv as pcv
from aggforce_torch.qp import fusedfeat as pff

import aggforce_tpu as jt
from aggforce_tpu.ops import eqp as jeqp
from aggforce_tpu.parallel import make_mesh as jax_make_mesh
from aggforce_tpu.parallel import sharded_force_smoothness as jax_smoothness
from aggforce_tpu.qp import cv as jcv
from aggforce_tpu.qp import fusedfeat as jff
from aggforce_tpu.qp import jgauss

REPO_ROOT = Path(__file__).resolve().parent.parent
N_FRAMES = 203
N_ATOMS = 30
GROUPS = {frozenset((i, i + 1)) for i in range(0, 10, 2)}
SITES = [[i] for i in range(0, N_ATOMS, 3)]  # 10 cg sites
KBT = 0.7
SEEDS = [3, 4, 5, 6, 7]  # 5 fits, windows of 2
L2S = [1e2, 1e3]
WORKER_TIMEOUT_S = 180

WORKER = textwrap.dedent(
    """
    import sys
    import numpy as np
    import torch

    torch.set_num_threads(1)
    repo, rank, world, store, inputs, out = sys.argv[1:7]
    sys.path.insert(0, repo)
    import torch.distributed as dist
    import aggforce_torch as pt
    from aggforce_torch import parallel as par
    from aggforce_torch.ops.eqp import batched_eqp_solve_shared_mesh
    from aggforce_torch.qp import cv as pcv
    from aggforce_torch.qp import fusedfeat as pff
    from aggforce_torch.utils.warmup import warm_featurized_fit

    par.initialize_distributed("file://" + store, int(world), int(rank), backend="gloo")
    mesh = par.make_mesh(device="cpu")
    d = np.load(inputs)
    coords, forces = d["coords"], d["forces"]
    n_atoms = coords.shape[1]
    cmap = pt.LinearMap([[i] for i in range(0, n_atoms, 3)], n_fg_sites=n_atoms)
    groups = {frozenset((i, i + 1)) for i in range(0, 10, 2)}
    spec = pff.GBFeatSpec(outer=2.0, n_basis=3)
    traj = pt.Trajectory(coords=coords, forces=forces)
    kw = dict(kbt=0.7, spec=spec, constraints=groups, l2_regularization=1e3,
              n_constraint_frames=8, device="cpu", mesh=mesh)
    res = {}

    def coefs(tmap):
        return np.stack(tmap.force_map.tags["coef_list"])

    # the main path: project_forces with the canonical featurizer
    feat = pt.Multifeaturize([pt.id_feat, pt.Curry(pt.gb_feat, outer=2.0, n_basis=3)])
    out_pf = pt.project_forces(
        coords, forces, cmap, constrained_inds=groups, method=pt.qp_feat_linear_map,
        featurizer=feat, kbt=0.7, l2_regularization=1e3, n_constraint_frames=8,
        constraint_rng=np.random.default_rng(5), mesh=mesh, device="cpu",
    )
    res["project_forces_feat"] = coefs(out_pf["tmap"])
    res["project_forces_feat_mapped"] = out_pf["mapped_forces"]
    fit = pff.fused_gb_linear_map(traj, cmap, constraint_rng=np.random.default_rng(5),
                                  use_kernel=False, chunk_size=64, **kw)
    res["fused_plain"] = coefs(fit)
    res["fused_plain_mapped"] = fit.map_arrays(coords[:20], forces[:20])[1]
    blocked = pff.fused_gb_linear_map_blocked(
        traj, cmap, constraint_rng=np.random.default_rng(5), site_block=2, **kw)
    res["blocked"] = coefs(blocked)
    res["blocked_tags"] = np.array([blocked.force_map.tags["solver_resid"],
                                    blocked.force_map.tags["escalated"]])
    kwb = dict(kw)
    kwb.pop("device")
    batch = pff.fused_gb_linear_map_batch(traj, cmap, seeds=[3, 4, 5, 6, 7],
                                          flush_every=2, device="cpu", **kwb)
    res["batch"] = np.stack([coefs(m) for m in batch])
    res["batch_mapped"] = np.stack([m.map_arrays(coords[:16], forces[:16])[1] for m in batch])

    # the linear paths
    out_lin = pt.project_forces(coords, forces, cmap, constrained_inds=groups,
                                l2_regularization=0.5, mesh=mesh, device="cpu")
    res["qp_linear"] = out_lin["tmap"].force_map.standard_matrix
    con = pt.qp.make_bond_constraint_matrix(n_atoms, groups)
    res["sharded_linear"] = par.sharded_linear_fit(forces, con, cmap.standard_matrix, 0.5, mesh)
    res["smoothness"] = np.array([par.sharded_force_smoothness(forces[:101], mesh)])

    # the shared-factor solver split over sites and fits
    rng = np.random.default_rng(11)
    f, s, m, n = 5, 10, 13, 40
    a_ = rng.normal(size=(s, n, n)).astype(np.float32)
    P = torch.as_tensor(a_ @ a_.transpose(0, 2, 1) / n + 0.5 * np.eye(n, dtype=np.float32))
    A = torch.as_tensor(rng.normal(size=(f, s, m, n)).astype(np.float32))
    B = torch.as_tensor(rng.normal(size=(f, s, m, 1)).astype(np.float32))
    x, r = batched_eqp_solve_shared_mesh(P, A, B, mesh, iters=40, return_resid=True)
    res["solve_x"], res["solve_resid"] = x.numpy(), r.numpy()

    # the CVs
    lin_cv = pcv.linear_map_cv(coords, forces, cmap, groups, [0.0, 1e2], n_folds=3,
                               rng=np.random.default_rng(2), mesh=mesh, device="cpu")
    res["linear_cv"] = np.array([v[0] for v in lin_cv.values()])
    feat_cv = pcv.fused_gb_cv(coords, forces, cmap, groups, 0.7, spec, [1e2, 1e3],
                              n_folds=3, n_constraint_frames=8,
                              rng=np.random.default_rng(1), mesh=mesh, device="cpu")
    res["feat_cv"] = np.array([v[0] for v in feat_cv.values()])
    grid = pt.project_forces_grid_cv(
        {"l2_regularization": [1e2, 1e3]}, coords, forces, n_folds=3,
        rng=np.random.default_rng(1), fast=True, coord_map=cmap, constrained_inds=groups,
        method=pt.qp_feat_linear_map, featurizer=feat, kbt=0.7, n_constraint_frames=8,
        mesh=mesh, device="cpu")
    res["grid_cv"] = np.array(list(grid["scores"].values()))

    # the Gaussian maps (a float32 tensor trajectory takes the one-sync fits)
    ttraj = pt.Trajectory(coords=torch.as_tensor(coords), forces=torch.as_tensor(forces))
    staged = pt.stagedjoptgauss_map(ttraj, cmap, var=0.3, kbt=0.7, seed=11, mesh=mesh,
                                    device="cpu")
    res["staged_pre"] = staged[1].force_map.standard_matrix
    res["staged_post"] = staged[0].tmap.force_map.standard_matrix
    staged = pt.stagedjoptgauss_map(traj, cmap, var=0.3, kbt=0.7, seed=11, mesh=mesh,
                                    device="cpu")
    res["staged_piecewise_pre"] = staged[1].force_map.standard_matrix
    jopt = pt.joptgauss_map(traj, cmap, var=0.3, kbt=0.7, seed=12, mesh=mesh, device="cpu")
    res["joptgauss"] = jopt.tmap.force_map.standard_matrix
    force_var = pt.stagedjforcegauss_map(traj, cmap, var=0.3, kbt=0.7, seed=13, mesh=mesh,
                                         device="cpu", contribution_tolerance=1e9)
    res["forcegauss_post"] = force_var[0].tmap.force_map.standard_matrix
    # no seed: every rank draws rank 0's
    res["staged_unseeded"] = pt.stagedjoptgauss_map(
        ttraj, cmap, var=0.3, kbt=0.7, mesh=mesh, device="cpu")[0].tmap.force_map.standard_matrix

    handle = warm_featurized_fit(64, cmap, spec, groups, mesh=mesh, device="cpu")
    handle.wait()
    res["warmup_error"] = np.array([handle.error is not None])
    # the generic path ignores the mesh
    gen = pt.qp_feat_linear_map(traj, cmap, pt.id_feat, 0.7, constraints=groups,
                                allow_fused=False, constraint_rng=np.random.default_rng(3),
                                mesh=mesh, device="cpu")
    res["generic"] = gen.map_arrays(coords[:8], forces[:8])[1]
    gen = pt.qp_feat_linear_map(traj, cmap, pt.id_feat, 0.7, constraints=groups,
                                allow_fused=False, constraint_rng=np.random.default_rng(3),
                                device="cpu")
    res["generic_single"] = gen.map_arrays(coords[:8], forces[:8])[1]
    np.savez(out, **res)
    dist.destroy_process_group()
    """
)

LINEAR_WORKER = textwrap.dedent(
    """
    import sys
    import numpy as np
    import torch

    torch.set_num_threads(1)
    repo, rank, world, store, inputs, out = sys.argv[1:7]
    sys.path.insert(0, repo)
    import torch.distributed as dist
    import aggforce_torch as pt
    from aggforce_torch import parallel as par

    par.initialize_distributed("file://" + store, int(world), int(rank), backend="gloo")
    mesh = par.make_mesh(device="cpu")
    d = np.load(inputs)
    forces = d["forces"]
    n_atoms = forces.shape[1]
    cmap = pt.LinearMap([[i] for i in range(0, n_atoms, 3)], n_fg_sites=n_atoms)
    groups = {frozenset((i, i + 1)) for i in range(0, 10, 2)}
    traj = pt.Trajectory(coords=d["coords"], forces=forces)
    res = {}
    res["qp_linear"] = pt.qp_linear_map(
        traj, cmap, groups, l2_regularization=0.5, mesh=mesh, device="cpu"
    ).force_map.standard_matrix
    con = pt.qp.make_bond_constraint_matrix(n_atoms, groups)
    res["sharded_linear"] = par.sharded_linear_fit(forces, con, cmap.standard_matrix, 0.5, mesh)
    np.savez(out, **res)
    dist.destroy_process_group()
    """
)


def _synth():
    """Random frames, as tests/test_parallel.py takes: on them the JAX
    package's own mesh and single-device fits agree to 1e-5 of mean|f|
    (a synthesized trajectory with rigid pairs pins the mapped forces
    weakly at this size: 9e-3 of mean|f| between JAX's two fits)."""
    rng = np.random.default_rng(3)
    coords = rng.normal(size=(N_FRAMES, N_ATOMS, 3)).astype(np.float32)
    forces = rng.normal(size=(N_FRAMES, N_ATOMS, 3)).astype(np.float32)
    return coords, forces


def run_workers(tmp, worker: str, world: int = 2, extra=()):
    """Run ``worker`` as ``world`` gloo ranks on a FileStore in ``tmp``;
    returns each rank's .npz contents. Fails with the workers' output when
    one fails or outlives WORKER_TIMEOUT_S."""
    script = tmp / "worker.py"
    script.write_text(worker)
    store = tmp / "store"
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("MASTER_ADDR", None)
    procs = [
        subprocess.Popen(
            [sys.executable, str(script), str(REPO_ROOT), str(rank), str(world),
             str(store), *extra, str(tmp / f"rank{rank}.npz")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env,
        )
        for rank in range(world)
    ]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=WORKER_TIMEOUT_S)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail("mesh workers timed out:\n" + "\n".join(
            p.communicate()[0] or "" for p in procs))
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{out}"
    return [dict(np.load(tmp / f"rank{rank}.npz")) for rank in range(world)]


@pytest.fixture(scope="module")
def system():
    return _synth()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, system):
    tmp = tmp_path_factory.mktemp("mesh")
    coords, forces = system
    np.savez(tmp / "inputs.npz", coords=coords, forces=forces)
    return run_workers(tmp, WORKER, extra=[str(tmp / "inputs.npz")])


def _cmap():
    return pt.LinearMap(SITES, n_fg_sites=N_ATOMS)


def _jcmap():
    return jt.LinearMap(SITES, n_fg_sites=N_ATOMS)


def _spec(package):
    return package.GBFeatSpec(outer=2.0, n_basis=3)


def _kw(package, **kw):
    return dict(
        kbt=KBT, spec=_spec(package), constraints=GROUPS, l2_regularization=1e3,
        n_constraint_frames=8, **kw,
    )


def _jax_mesh():
    return jax_make_mesh(jax.devices()[:2])


def _scaled_close(got, ref, tol):
    """|got - ref| <= tol * mean|ref| everywhere."""
    ref = np.asarray(ref)
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol * np.abs(ref).mean())


@pytest.mark.parametrize(
    "key",
    ["project_forces_feat", "fused_plain", "blocked", "blocked_tags", "batch",
     "qp_linear", "sharded_linear", "smoothness", "solve_x", "solve_resid",
     "linear_cv", "feat_cv", "grid_cv", "staged_pre", "staged_post",
     "staged_piecewise_pre", "joptgauss", "forcegauss_post", "staged_unseeded",
     "generic", "warmup_error"],
)
def test_ranks_agree_bit_for_bit(ranks, key):
    """Every rank returns the same result: the draws are rank 0's, the
    decisions read replicated values and the solves run on the reduced
    Grams."""
    np.testing.assert_array_equal(ranks[0][key], ranks[1][key])


def test_featurized_mesh_fit_matches_single_device_and_jax(ranks, system):
    """The main path, project_forces with the canonical featurizer over the
    mesh: mapped forces within 2e-3 * mean|f| of the port's single-device
    fit and of the JAX package's fit on its 2-device mesh."""
    coords, forces = system
    single = pff.fused_gb_linear_map(
        pt.Trajectory(coords=coords, forces=forces), _cmap(),
        constraint_rng=np.random.default_rng(5), device="cpu", **_kw(pff),
    )
    f_single = single.map_arrays(coords, forces)[1]
    _scaled_close(ranks[0]["project_forces_feat_mapped"], f_single, 2e-3)
    jmap = jff.fused_gb_linear_map(
        jt.Trajectory(coords=coords, forces=forces), _jcmap(),
        constraint_rng=np.random.default_rng(5), mesh=_jax_mesh(), **_kw(jff),
    )
    _scaled_close(ranks[0]["project_forces_feat_mapped"], jmap.map_arrays(coords, forces)[1], 2e-3)
    _scaled_close(ranks[0]["fused_plain_mapped"], f_single[:20], 2e-3)


def test_blocked_mesh_fit_matches_single_device(ranks, system):
    """The site blocks split over the ranks (2 sites a block, 4 a step, the
    last step ragged: rank 1 fits only padding there) give the
    single-device blocked fit's coefficients to float32 rounding (each
    site's problem is the same; only the ranks' blocks differ in
    composition), and its mapped forces within 2e-3 * mean|f|."""
    coords, forces = system
    single = pff.fused_gb_linear_map_blocked(
        pt.Trajectory(coords=coords, forces=forces), _cmap(),
        constraint_rng=np.random.default_rng(5), site_block=2, device="cpu", **_kw(pff),
    )
    got = ranks[0]["blocked"]
    assert got.shape == (len(SITES), np.stack(single.force_map.tags["coef_list"]).shape[1])
    fmap = pff.FusedGBMap(
        got, _cmap().standard_matrix, single.force_map._onehot.numpy(),
        single.force_map._centers.numpy(), KBT, _spec(pff), device="cpu",
    )
    _scaled_close(fmap(forces, coords), single.map_arrays(coords, forces)[1], 2e-3)
    assert ranks[0]["blocked_tags"][1] == single.force_map.tags["escalated"]


def test_batch_mesh_fits_match_single_device_and_jax(ranks, system):
    """One frame-sharded Gram per window and the split shared solve: each
    seed's mapped forces within 2e-3 * max|f| of the port's single-device
    batch and of the JAX package's mesh batch."""
    coords, forces = system
    single = pff.fused_gb_linear_map_batch(
        pt.Trajectory(coords=coords, forces=forces), _cmap(), seeds=SEEDS, flush_every=2,
        device="cpu", **_kw(pff),
    )
    jbatch = jff.fused_gb_linear_map_batch(
        jt.Trajectory(coords=coords, forces=forces), _jcmap(), seeds=SEEDS, flush_every=2,
        mesh=_jax_mesh(), **_kw(jff),
    )
    assert len(ranks[0]["batch_mapped"]) == len(SEEDS)
    for got, one, jone in zip(ranks[0]["batch_mapped"], single, jbatch):
        ref = one.map_arrays(coords[:16], forces[:16])[1]
        np.testing.assert_allclose(got, ref, atol=2e-3 * np.abs(ref).max())
        jref = np.asarray(jone.map_arrays(coords[:16], forces[:16])[1])
        np.testing.assert_allclose(got, jref, atol=2e-3 * np.abs(jref).max())


def test_linear_mesh_fits_match_single_device_and_jax(ranks, system):
    """qp_linear_map(mesh=) through project_forces and sharded_linear_fit:
    within 2e-4 of the single-device device fit and of the JAX package's
    sharded fit."""
    coords, forces = system
    single = pt.qp_linear_map(
        pt.Trajectory(coords=coords, forces=forces), _cmap(), GROUPS,
        l2_regularization=0.5, device="cpu",
    ).force_map.standard_matrix
    from aggforce_tpu.parallel import sharded_linear_fit

    con = pt.qp.make_bond_constraint_matrix(N_ATOMS, GROUPS).astype(np.float32)
    jax_map = sharded_linear_fit(
        forces, con, _cmap().standard_matrix.astype(np.float32), 0.5, mesh=_jax_mesh()
    )
    for key in ("qp_linear", "sharded_linear"):
        np.testing.assert_allclose(ranks[0][key], single, atol=2e-4)
        np.testing.assert_allclose(ranks[0][key], np.asarray(jax_map), atol=2e-4)


@pytest.mark.parametrize("world", [1, 2])
def test_sharded_linear_fit_is_the_mesh_linear_fit(tmp_path, system, world):
    """sharded_linear_fit is qp_linear_map(mesh=)'s device fit on the labels
    of its duplication matrix: the same map bit for bit on every rank."""
    coords, forces = system
    np.savez(tmp_path / "inputs.npz", coords=coords, forces=forces)
    out = run_workers(tmp_path, LINEAR_WORKER, world=world, extra=[str(tmp_path / "inputs.npz")])
    for res in out:
        assert res["sharded_linear"].shape == (len(SITES), N_ATOMS)
        np.testing.assert_array_equal(res["sharded_linear"], res["qp_linear"])


def test_sharded_linear_fit_refuses_a_matrix_that_is_not_one_hot(system):
    """Only a one-hot duplication matrix has labels: any other raises before
    a mesh is asked for."""
    from aggforce_torch.parallel import sharded_linear_fit

    _, forces = system
    con = pt.qp.make_bond_constraint_matrix(N_ATOMS, GROUPS)
    two_ones = con.copy()
    two_ones[0, 1] = 1.0
    for bad in (two_ones, 0.5 * con, con[:, :-1], con[0]):
        with pytest.raises(ValueError, match="one-hot duplication matrix"):
            sharded_linear_fit(forces, bad, _cmap().standard_matrix)


def test_sharded_force_smoothness(ranks, system):
    """101 frames over 2 ranks: the mean square within rtol 1e-5 of the
    serial value and of the JAX package's sharded one."""
    _, forces = system
    ref = pt.force_smoothness(forces[:101])
    np.testing.assert_allclose(ranks[0]["smoothness"][0], ref, rtol=1e-5)
    np.testing.assert_allclose(
        ranks[0]["smoothness"][0], jax_smoothness(forces[:101], mesh=_jax_mesh()), rtol=1e-5
    )


def _solve_problem():
    """The workers' shared-factor problem: 5 fits, 10 sites, m 13, n 40."""
    rng = np.random.default_rng(11)
    f, s, m, n = 5, 10, 13, 40
    a_ = rng.normal(size=(s, n, n)).astype(np.float32)
    P = a_ @ a_.transpose(0, 2, 1) / n + 0.5 * np.eye(n, dtype=np.float32)
    A = rng.normal(size=(f, s, m, n)).astype(np.float32)
    B = rng.normal(size=(f, s, m, 1)).astype(np.float32)
    return P, A, B


def test_shared_solve_mesh_matches_replicated(ranks):
    """The solve split over sites (10: identity padding to 2 ranks' worth
    is none, fits 5: the last repeated) within rtol 2e-4, atol 2e-5 of the
    port's replicated solver and of JAX's mesh solver on 2 devices
    (residuals rtol 1e-3, atol 1e-6 of the replicated ones)."""
    P, A, B = _solve_problem()
    x_ref, r_ref = peqp.batched_eqp_solve_shared(
        torch.as_tensor(P), torch.as_tensor(A), torch.as_tensor(B), iters=40,
        return_resid=True,
    )
    x_jax, _ = jeqp.batched_eqp_solve_shared_mesh(
        P, A, B, mesh=_jax_mesh(), iters=40, return_resid=True
    )
    np.testing.assert_allclose(ranks[0]["solve_x"], x_ref.numpy(), rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(ranks[0]["solve_x"], np.asarray(x_jax), rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(ranks[0]["solve_resid"], r_ref.numpy(), rtol=1e-3, atol=1e-6)


def test_mesh_cvs_match_single_device_and_jax(ranks, system):
    """linear_map_cv, fused_gb_cv and project_forces_grid_cv over the mesh:
    scores within 1e-4 relative of the single-device port's and of the JAX
    package's mesh CVs (folds and samples from the same generator)."""
    coords, forces = system
    lin = pcv.linear_map_cv(
        coords, forces, _cmap(), GROUPS, [0.0, 1e2], n_folds=3,
        rng=np.random.default_rng(2), device="cpu",
    )
    jlin = jcv.linear_map_cv(
        coords, forces, _jcmap(), GROUPS, [0.0, 1e2], n_folds=3,
        rng=np.random.default_rng(2), mesh=_jax_mesh(),
    )
    feat = pcv.fused_gb_cv(
        coords, forces, _cmap(), GROUPS, KBT, _spec(pff), L2S, n_folds=3,
        n_constraint_frames=8, rng=np.random.default_rng(1), device="cpu",
    )
    jfeat = jcv.fused_gb_cv(
        coords, forces, _jcmap(), GROUPS, KBT, _spec(jff), L2S, n_folds=3,
        n_constraint_frames=8, rng=np.random.default_rng(1), mesh=_jax_mesh(),
    )
    for got, tables in (
        (ranks[0]["linear_cv"], (lin, jlin)),
        (ranks[0]["feat_cv"], (feat, jfeat)),
        (ranks[0]["grid_cv"], (feat,)),
    ):
        for table in tables:
            ref = np.array([v[0] for v in table.values()])
            np.testing.assert_allclose(got, ref, rtol=1e-4)


def test_staged_gauss_mesh_matches_single_device_and_jax(ranks, system):
    """stagedjoptgauss_map(mesh=) on its one-sync path: the premap within
    5e-5 of the single-device fit and of the JAX package's (a deterministic
    stage); the noise stage, which takes the same torch draw sliced per
    rank, within 5e-5 of the single-device one. The piecewise path's premap
    (a mesh qp_linear_map) too. The JAX package's mesh version of the
    one-dispatch program refuses 203 frames on 2 devices (its frame axis
    must divide), so its unsharded fit is the reference here."""
    coords, forces = system
    ttraj = pt.Trajectory(coords=torch.as_tensor(coords), forces=torch.as_tensor(forces))
    single = pt.stagedjoptgauss_map(ttraj, _cmap(), var=0.3, kbt=KBT, seed=11, device="cpu")
    jtraj = jt.Trajectory(coords=jax.numpy.asarray(coords), forces=jax.numpy.asarray(forces))
    with pytest.raises(ValueError, match="divisible"):
        jgauss.stagedjoptgauss_map(jtraj, _jcmap(), var=0.3, kbt=KBT, seed=11, mesh=_jax_mesh())
    jstaged = jgauss.stagedjoptgauss_map(jtraj, _jcmap(), var=0.3, kbt=KBT, seed=11)
    pre = single[1].force_map.standard_matrix
    for key in ("staged_pre", "staged_piecewise_pre"):
        np.testing.assert_allclose(ranks[0][key], pre, atol=5e-5)
        np.testing.assert_allclose(
            ranks[0][key], np.asarray(jstaged[1].force_map.standard_matrix), atol=5e-5
        )
    np.testing.assert_allclose(
        ranks[0]["staged_post"], single[0].tmap.force_map.standard_matrix, atol=5e-5
    )


def test_gauss_builders_take_the_mesh_like_jax(ranks, system):
    """joptgauss_map and stagedjforcegauss_map pass the mesh to their
    linear fits (the second stage alone for the force variant), with the
    seed's draw: within 5e-5 of the single-device builders."""
    coords, forces = system
    traj = pt.Trajectory(coords=coords, forces=forces)
    jopt = pt.joptgauss_map(traj, _cmap(), var=0.3, kbt=KBT, seed=12, device="cpu")
    np.testing.assert_allclose(
        ranks[0]["joptgauss"], jopt.tmap.force_map.standard_matrix, atol=5e-5
    )
    force_var = pt.stagedjforcegauss_map(
        traj, _cmap(), var=0.3, kbt=KBT, seed=13, device="cpu", contribution_tolerance=1e9,
    )
    np.testing.assert_allclose(
        ranks[0]["forcegauss_post"], force_var[0].tmap.force_map.standard_matrix, atol=5e-5
    )


def test_generic_path_and_warmup_over_the_mesh(ranks, system):
    """The generic featurizer path ignores the mesh (the single-device map,
    as in the JAX package), and warm_featurized_fit(mesh=) runs its mesh
    fit without error."""
    coords, forces = system
    gen = pt.qp_feat_linear_map(
        pt.Trajectory(coords=coords, forces=forces), _cmap(), pt.id_feat, KBT,
        constraints=GROUPS, allow_fused=False, constraint_rng=np.random.default_rng(3),
        device="cpu",
    )
    # bit for bit against the same process's single-device fit; this
    # process sums with more threads
    np.testing.assert_array_equal(ranks[0]["generic"], ranks[0]["generic_single"])
    ref = gen.map_arrays(coords[:8], forces[:8])[1]
    np.testing.assert_allclose(ranks[0]["generic"], ref, rtol=0, atol=1e-5 * np.abs(ref).max())
    assert not ranks[0]["warmup_error"][0]
