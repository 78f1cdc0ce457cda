"""The port's process layer: joining processes, splitting frames, the
mesh argument's checks and the streamed fits with per-process frame slices.

In this process a world-size-1 gloo group is made and destroyed by each
test that needs one (none is left behind). The multi-process checks run two
worker processes joined through a FileStore in a temporary directory, and
compare what they wrote with each other (bit for bit), with the port's
single-process fits and with the JAX package's streamed fit. Tolerances,
the single-process port tests' (tests/test_torch_stream.py): a streamed
linear fit with ``frame_slice`` matches the in-memory map to 5e-5, a
streamed featurized fit the in-memory fit's mapped forces to 1e-3 RMS
relative; and the JAX package's own two-process test's
(tests/test_distributed.py:809): coefficients within 5e-4 of the largest of
its single-process streamed fit.
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist

import aggforce_torch as pt
from aggforce_torch import parallel as par
from aggforce_torch.io import TrajectoryStream, fused_gb_linear_map_streamed, qp_linear_map_streamed
from aggforce_torch.ops.eqp import batched_eqp_solve_shared_mesh
from aggforce_torch.qp import cv as pcv
from aggforce_torch.qp import fusedfeat as pff
from aggforce_torch.utils.warmup import warm_featurized_fit

import aggforce_tpu as jt
from aggforce_tpu.io import TrajectoryStream as JStream
from aggforce_tpu.io import fused_gb_linear_map_streamed as jax_streamed
from aggforce_tpu.qp import fusedfeat as jff

from test_torch_parallel import run_workers

N_FRAMES = 203
N_ATOMS = 12
GROUPS = {frozenset((0, 1)), frozenset((4, 5))}
SITES = [[0], [4], [8]]
KBT = 0.6955215
CHUNK = 32

WORKER = """
import sys
import numpy as np
import torch

torch.set_num_threads(1)
repo, rank, world, store, inputs, out = sys.argv[1:7]
sys.path.insert(0, repo)
import torch.distributed as dist
import aggforce_torch as pt
from aggforce_torch import parallel as par
from aggforce_torch.io import TrajectoryStream, fused_gb_linear_map_streamed, qp_linear_map_streamed
from aggforce_torch.qp import fusedfeat as pff

par.initialize_distributed("file://" + store, int(world), int(rank), backend="gloo")
par.initialize_distributed("file://" + store, int(world), int(rank), backend="gloo")
res = {"slices": np.array([[s.start, s.stop] for s in map(par.process_frame_slice, (203, 204, 1))]),
       "world": np.array([dist.get_world_size(), dist.get_rank()])}
mesh = par.global_frame_mesh(device="cpu")
d = np.load(inputs)
coords, forces = d["coords"], d["forces"]
cmap = pt.LinearMap([[0], [4], [8]], n_fg_sites=coords.shape[1])
groups = {frozenset((0, 1)), frozenset((4, 5))}
spec = pff.GBFeatSpec(outer=2.0, n_basis=4)
kw = dict(kbt=0.6955215, spec=spec, constraints=groups, l2_regularization=1e3,
          n_constraint_frames=10, device="cpu")
stream = TrajectoryStream.from_arrays(coords, forces, chunk_size=32)
sl = par.process_frame_slice(stream.n_frames)
fit = fused_gb_linear_map_streamed(stream, cmap, constraint_rng=np.random.default_rng(0),
                                   mesh=mesh, frame_slice=sl, **kw)
res["feat_slice"] = np.stack(fit.force_map.tags["coef_list"])
res["feat_slice_mapped"] = fit.map_arrays(coords, forces)[1]
fit = fused_gb_linear_map_streamed(stream, cmap, constraint_rng=np.random.default_rng(0),
                                   mesh=mesh, **kw)
res["feat_round_robin"] = np.stack(fit.force_map.tags["coef_list"])
lin = qp_linear_map_streamed(stream, cmap, groups, mesh=mesh, frame_slice=sl, device="cpu")
res["linear_slice"] = lin.force_map.standard_matrix
lin = qp_linear_map_streamed(stream, cmap, groups, mesh=mesh, resid_tol=0.0, device="cpu")
res["linear_escalated"] = lin.force_map.standard_matrix

traj = pt.Trajectory(coords=coords, forces=forces)
# no constraint_rng: every rank still takes rank 0's draw, on the fused
# path and on the generic path (which fits every frame on each rank)
res["unseeded"] = np.stack(pff.fused_gb_linear_map(traj, cmap, mesh=mesh, **kw)
                           .force_map.tags["coef_list"])
generic = dict(constraints=groups, allow_fused=False, mesh=mesh, device="cpu")
res["generic_unseeded"] = np.stack(pt.qp_feat_linear_map(
    traj, cmap, pt.id_feat, 0.6955215, **generic).force_map.tags["coef_list"])
res["generic_seeded_mapped"] = pt.qp_feat_linear_map(
    traj, cmap, pt.id_feat, 0.6955215, constraint_rng=np.random.default_rng(5), **generic
).map_arrays(coords, forces)[1]
dist.destroy_process_group()
res["destroyed"] = np.array([dist.is_initialized()])
np.savez(out, **res)
"""


@pytest.fixture(scope="module")
def system():
    rng = np.random.default_rng(3)
    coords = rng.normal(size=(N_FRAMES, N_ATOMS, 3)).astype(np.float32)
    forces = rng.normal(size=(N_FRAMES, N_ATOMS, 3)).astype(np.float32)
    return coords, forces


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, system):
    tmp = tmp_path_factory.mktemp("dist")
    np.savez(tmp / "inputs.npz", coords=system[0], forces=system[1])
    return run_workers(tmp, WORKER, extra=[str(tmp / "inputs.npz")])


@pytest.fixture
def one_rank():
    """A world-size-1 gloo group for the test, destroyed after it."""
    par.initialize_distributed(backend="gloo")
    try:
        yield par.make_mesh(device="cpu")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _cmap():
    return pt.LinearMap(SITES, n_fg_sites=N_ATOMS)


def _kw():
    return dict(
        kbt=KBT, spec=pff.GBFeatSpec(outer=2.0, n_basis=4), constraints=GROUPS,
        l2_regularization=1e3, n_constraint_frames=10, device="cpu",
    )


def test_initialize_distributed_world_size_one_and_twice(one_rank):
    """With no cluster and no process count, a real world-size-1 group;
    calling again does nothing, and asking for another size raises."""
    assert dist.is_initialized() and dist.get_world_size() == 1
    par.initialize_distributed()
    assert dist.get_world_size() == 1
    with pytest.raises(ValueError, match="1 processes, not 2"):
        par.initialize_distributed(num_processes=2)
    assert one_rank.size == 1 and one_rank.rank == 0
    assert one_rank.mesh_dim_names == ("frames",) and one_rank.ndim == 1


def test_initialize_distributed_needs_an_address_for_many():
    with pytest.raises(ValueError, match="coordinator_address"):
        par.initialize_distributed(num_processes=2, backend="gloo")
    with pytest.raises(ValueError, match="process_id"):
        par.initialize_distributed("localhost:1", num_processes=2, backend="gloo")
    assert not dist.is_initialized()


@pytest.mark.parametrize("n_frames, world", [(203, 2), (204, 2), (10, 3), (2, 4), (7, 1)])
def test_process_frame_slice_splits_evenly(monkeypatch, n_frames, world):
    """Contiguous, covering, sizes within one frame of each other, earlier
    processes taking the remainder (the JAX package's split)."""
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda: world)
    slices = []
    for pid in range(world):
        monkeypatch.setattr(dist, "get_rank", lambda pid=pid: pid)
        slices.append(par.process_frame_slice(n_frames))
    assert slices[0].start == 0 and slices[-1].stop == n_frames
    assert all(a.stop == b.start for a, b in zip(slices, slices[1:]))
    sizes = [s.stop - s.start for s in slices]
    assert sizes == sorted(sizes, reverse=True) and max(sizes) - min(sizes) <= 1


def test_process_frame_slice_without_a_group():
    assert not dist.is_initialized()
    assert par.process_frame_slice(203) == slice(0, 203)


def test_workers_join_slice_and_leave(ranks):
    """Two ranks joined through the file store (initialize_distributed
    called twice), their process_frame_slice of 203 (uneven), 204 (even)
    and 1 frames, and no group left after destroy_process_group."""
    for rank, res in enumerate(ranks):
        assert res["world"].tolist() == [2, rank]
        assert not res["destroyed"][0]
    assert ranks[0]["slices"].tolist() == [[0, 102], [0, 102], [0, 1]]
    assert ranks[1]["slices"].tolist() == [[102, 203], [102, 204], [1, 1]]


@pytest.mark.parametrize(
    "key",
    ["feat_slice", "feat_round_robin", "linear_slice", "linear_escalated", "unseeded",
     "generic_unseeded"],
)
def test_ranks_agree_bit_for_bit(ranks, key):
    np.testing.assert_array_equal(ranks[0][key], ranks[1][key])


def test_generic_path_on_a_mesh_is_the_single_process_fit(ranks, system):
    """The generic path fits every frame on each rank (the mesh is
    ignored, as in the JAX package): with a seeded constraint draw the
    mapped forces match the single-process fit's within 2e-3 mean|f| (the
    featurized tolerance of the JAX mesh tests; the workers run one thread,
    this process several)."""
    coords, forces = system
    single = pt.qp_feat_linear_map(
        pt.Trajectory(coords=coords, forces=forces), _cmap(), pt.id_feat, KBT,
        constraints=GROUPS, allow_fused=False, constraint_rng=np.random.default_rng(5),
        device="cpu",
    ).map_arrays(coords, forces)[1]
    for res in ranks:
        np.testing.assert_allclose(
            res["generic_seeded_mapped"], single, rtol=0, atol=2e-3 * np.abs(single).mean()
        )


def test_streamed_mesh_fits_match_in_memory_and_jax(ranks, system):
    """Each rank streams its process_frame_slice (or every other chunk)
    and one all-reduce sums the Grams: the featurized map's mapped forces
    within 1e-3 RMS (relative) of the in-memory fit's, its coefficients
    within 5e-4 of the largest of the JAX package's streamed fit's; the
    linear map within 5e-5 of the in-memory fit, escalated or not."""
    coords, forces = system
    traj = pt.Trajectory(coords=coords, forces=forces)
    mem = pff.fused_gb_linear_map(traj, _cmap(), constraint_rng=np.random.default_rng(0), **_kw())
    ref = mem.map_arrays(coords, forces)[1]
    rms = np.sqrt(np.mean((ranks[0]["feat_slice_mapped"] - ref) ** 2))
    assert rms < 1e-3 * np.sqrt(np.mean(ref**2))
    kw = _kw()
    kw.pop("device")
    kw["spec"] = jff.GBFeatSpec(outer=2.0, n_basis=4)
    jmap = jax_streamed(
        JStream.from_arrays(coords, forces, chunk_size=CHUNK), jt.LinearMap(SITES, n_fg_sites=N_ATOMS),
        constraint_rng=np.random.default_rng(0), **kw,
    )
    jc = np.stack(jmap.force_map.tags["coef_list"])
    for key in ("feat_slice", "feat_round_robin"):
        np.testing.assert_allclose(ranks[0][key], jc, rtol=0, atol=5e-4 * np.abs(jc).max())
    lin = pt.qp_linear_map(traj, _cmap(), GROUPS, device="cpu").force_map.standard_matrix
    for key in ("linear_slice", "linear_escalated"):
        np.testing.assert_allclose(ranks[0][key], lin, atol=5e-5)


# --- the mesh argument's checks ----------------------------------------------


def _entry_points(mesh, coords, forces):
    traj = pt.Trajectory(coords=coords, forces=forces)
    stream = TrajectoryStream.from_arrays(coords, forces, chunk_size=CHUNK)
    kw = _kw()
    spec = kw["spec"]
    return {
        "fused": lambda: pff.fused_gb_linear_map(traj, _cmap(), mesh=mesh, **kw),
        "blocked": lambda: pff.fused_gb_linear_map_blocked(traj, _cmap(), mesh=mesh, **kw),
        "batch": lambda: pff.fused_gb_linear_map_batch(traj, _cmap(), seeds=[1], mesh=mesh, **kw),
        "qp_linear_map": lambda: pt.qp_linear_map(traj, _cmap(), GROUPS, mesh=mesh, device="cpu"),
        "linear_map_cv": lambda: pcv.linear_map_cv(
            coords, forces, _cmap(), GROUPS, [0.0], n_folds=2, mesh=mesh, device="cpu"),
        "fused_gb_cv": lambda: pcv.fused_gb_cv(
            coords, forces, _cmap(), GROUPS, KBT, spec, [1e3], n_folds=2, mesh=mesh,
            device="cpu"),
        "stagedjoptgauss_map": lambda: pt.stagedjoptgauss_map(
            traj, _cmap(), var=0.1, kbt=KBT, mesh=mesh, device="cpu"),
        "streamed_linear": lambda: qp_linear_map_streamed(stream, _cmap(), mesh=mesh, device="cpu"),
        "streamed_featurized": lambda: fused_gb_linear_map_streamed(
            stream, _cmap(), mesh=mesh, **kw),
        "warm_featurized_fit": lambda: warm_featurized_fit(
            16, _cmap(), spec, GROUPS, mesh=mesh, device="cpu"),
        "generic_path": lambda: pt.qp_feat_linear_map(
            traj, _cmap(), pt.id_feat, KBT, allow_fused=False, mesh=mesh, device="cpu"),
        "shared_solve": lambda: batched_eqp_solve_shared_mesh(
            torch.eye(3)[None], torch.ones(1, 1, 1, 3), torch.ones(1, 1, 1, 1), mesh),
        "sharded_linear_fit": lambda: par.sharded_linear_fit(
            forces, np.eye(N_ATOMS), _cmap().standard_matrix, mesh=mesh),
    }


ENTRY_POINTS = sorted(_entry_points(None, np.zeros((4, N_ATOMS, 3)), np.zeros((4, N_ATOMS, 3))))


@pytest.mark.parametrize("entry", ENTRY_POINTS)
def test_mesh_that_is_no_mesh_raises_type_error(system, entry):
    with pytest.raises(TypeError, match="FrameMesh"):
        _entry_points(object(), *system)[entry]()


@pytest.mark.parametrize("entry", ["fused", "qp_linear_map", "fused_gb_cv"])
def test_mesh_of_another_axis_raises(one_rank, system, entry):
    mesh = par.make_mesh(axis_name="sites", device="cpu")
    with pytest.raises(ValueError, match="'frames' axis"):
        _entry_points(mesh, *system)[entry]()


def test_two_dimensional_device_mesh_raises(one_rank, system):
    """A DeviceMesh is not the port's mesh: make_mesh gives this rank's
    FrameMesh."""
    from torch.distributed.device_mesh import init_device_mesh

    mesh = init_device_mesh("cpu", (1, 1), mesh_dim_names=("frames", "sites"))
    with pytest.raises(TypeError, match="FrameMesh"):
        _entry_points(mesh, *system)["fused"]()


def test_one_dimensional_device_mesh_raises(one_rank, system):
    from torch.distributed.device_mesh import init_device_mesh

    mesh = init_device_mesh("cpu", (1,), mesh_dim_names=("frames",))
    with pytest.raises(TypeError, match="FrameMesh"):
        _entry_points(mesh, *system)["fused"]()


def test_mesh_without_a_process_group_raises(system):
    """make_mesh, and a mesh whose group is gone, name
    initialize_distributed; there is no quiet single-device fit."""
    with pytest.raises(RuntimeError, match="initialize_distributed"):
        par.make_mesh(device="cpu")
    par.initialize_distributed(backend="gloo")
    mesh = par.make_mesh(device="cpu")
    dist.destroy_process_group()
    with pytest.raises(RuntimeError, match="initialize_distributed"):
        _entry_points(mesh, *system)["fused"]()


def test_mesh_and_another_device_raise(one_rank, system):
    coords, forces = system
    with pytest.raises(ValueError, match="mesh device"):
        pff.fused_gb_linear_map(
            pt.Trajectory(coords=coords, forces=forces), _cmap(), mesh=one_rank,
            **dict(_kw(), device="cuda"),
        )
