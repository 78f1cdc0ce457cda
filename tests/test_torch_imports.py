"""The PyTorch port stands alone: no JAX, no JAX package, GPU by default."""

import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO_ROOT = Path(__file__).resolve().parent.parent
PORT = REPO_ROOT / "aggforce_torch"
IMPORT_RE = re.compile(r"^\s*(import|from)\s+(jax|aggforce_tpu)\b", re.MULTILINE)


def test_import_pulls_in_no_jax():
    code = (
        "import sys, aggforce_torch, aggforce_torch.convert, "
        "aggforce_torch.ops.gram, aggforce_torch.ops._build, "
        "aggforce_torch.qp.fusedfeat, aggforce_torch.utils.synth, "
        "aggforce_torch.constraints.finder, aggforce_torch.qp.qplinear, "
        "aggforce_torch.qp.basicagg, aggforce_torch.qp.cv, "
        "aggforce_torch.utils.pdblite, "
        "aggforce_torch.ops.eqp, aggforce_torch.ops.torchcore, aggforce_torch.agg, "
        "aggforce_torch.trajectory.gaussian, aggforce_torch.qp.gauss, "
        "aggforce_torch.qp.gauss_fused, aggforce_torch.mapval, aggforce_torch.models, "
        "aggforce_torch.io, aggforce_torch.io.stream, aggforce_torch.io.staging, "
        "aggforce_torch.utils.serialize, aggforce_torch.utils.warmup, "
        "aggforce_torch.utils.prof, aggforce_torch.utils.debug, "
        "aggforce_torch.utils.devcache, aggforce_torch.utils.cache, "
        "aggforce_torch.util, aggforce_torch.torchutil, aggforce_torch.parallel, "
        "aggforce_torch.parallel.mesh, aggforce_torch.parallel.distributed\n"
        "bad = [m for m in sys.modules if m in ('jax', 'aggforce_tpu') "
        "or m.startswith(('jax.', 'aggforce_tpu.'))]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO_ROOT, capture_output=True,
        text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


TWINS = sorted((REPO_ROOT / "examples").glob("torch_*.py"))


@pytest.mark.parametrize(
    "path",
    sorted(PORT.rglob("*.py")) + [REPO_ROOT / "chip_smoke.py"] + TWINS,
    ids=lambda p: str(p.relative_to(REPO_ROOT)),
)
def test_sources_do_not_import_jax(path):
    text = path.read_text()
    assert not IMPORT_RE.search(text)
    if path.is_relative_to(PORT) or path in TWINS:
        # the port names its JAX counterparts in prose, never by package
        assert "aggforce_tpu" not in text


def test_twins_run_without_jax():
    """Two of the example twins run end to end (on the CPU, tiny) and
    leave neither JAX nor the JAX package in ``sys.modules``; the other
    twins' imports are in ``test_sources_do_not_import_jax``."""
    code = (
        "import importlib.util, sys\n"
        "for name, argv in (('torch_gauss', ['--frames', '40']),\n"
        "                   ('torch_bootstrap', ['--n-maps', '2', '--window', '2'])):\n"
        "    spec = importlib.util.spec_from_file_location(name, f'examples/{name}.py')\n"
        "    mod = importlib.util.module_from_spec(spec)\n"
        "    spec.loader.exec_module(mod)\n"
        "    mod.main(['--device', 'cpu', *argv])\n"
        "bad = [m for m in sys.modules if m in ('jax', 'aggforce_tpu') "
        "or m.startswith(('jax.', 'aggforce_tpu.'))]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO_ROOT, capture_output=True,
        text=True, timeout=300, env=dict(os.environ, OMP_NUM_THREADS="1"),
    )
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]


def _fixture():
    from aggforce_torch import LinearMap

    rng = np.random.default_rng(0)
    coords = rng.normal(size=(8, 6, 3)).astype(np.float32)
    forces = rng.normal(size=(8, 6, 3)).astype(np.float32)
    return coords, forces, LinearMap([[0], [3]], n_fg_sites=6)


def _project_forces():
    from aggforce_torch import Curry, Multifeaturize, gb_feat, id_feat
    from aggforce_torch import project_forces, qp_feat_linear_map

    coords, forces, cmap = _fixture()
    project_forces(
        coords, forces, cmap, constrained_inds=set(),
        method=qp_feat_linear_map,
        featurizer=Multifeaturize([id_feat, Curry(gb_feat, outer=1.0, n_basis=3)]),
        kbt=0.7,
    )


def _fused_fit():
    from aggforce_torch import Trajectory
    from aggforce_torch.qp.fusedfeat import GBFeatSpec, fused_gb_linear_map

    coords, forces, cmap = _fixture()
    fused_gb_linear_map(
        Trajectory(coords=coords, forces=forces), cmap, kbt=0.7,
        spec=GBFeatSpec(outer=1.0, n_basis=3),
    )


def _blocked_fit():
    from aggforce_torch import Trajectory
    from aggforce_torch.qp import GBFeatSpec, fused_gb_linear_map_blocked

    coords, forces, cmap = _fixture()
    fused_gb_linear_map_blocked(
        Trajectory(coords=coords, forces=forces), cmap, kbt=0.7,
        spec=GBFeatSpec(outer=1.0, n_basis=3), site_block=1,
    )


def _tlinear_map():
    from aggforce_torch import TLinearMap

    TLinearMap([[0], [3]], n_fg_sites=6)


def _map_carry():
    from aggforce_torch.convert import fused_map_from_numpy

    fused_map_from_numpy(
        np.zeros((1, 4)), np.eye(1, 2), np.eye(2), np.ones(1), 0.7,
        {"outer": 1.0, "n_basis": 1},
    )


def _gb_feat():
    from aggforce_torch import gb_feat

    coords, _, cmap = _fixture()
    gb_feat(coords, cmap, set(), outer=1.0, lazy=False)


def _project_forces_defaults():
    from aggforce_torch import project_forces

    coords, forces, cmap = _fixture()
    project_forces(coords, forces, cmap)


def _linear_fit():
    from aggforce_torch import Trajectory, qp_linear_map

    coords, forces, cmap = _fixture()
    qp_linear_map(Trajectory(coords=coords, forces=forces), cmap)


def _finder():
    from aggforce_torch import guess_pairwise_constraints

    guess_pairwise_constraints(_fixture()[0])


def _fold_probe():
    from aggforce_torch.constraints.finder import fold_train_constraint_probe

    fold_train_constraint_probe(_fixture()[0], [np.arange(4), np.arange(4, 8)])


def _linear_cv():
    from aggforce_torch.qp.cv import linear_map_cv

    coords, forces, cmap = _fixture()
    linear_map_cv(coords, forces, cmap, set(), l2_values=[0.0], n_folds=2)


def _device_synthesis():
    from aggforce_torch.utils.synth import synthesize_trajectory_device

    synthesize_trajectory_device(np.zeros((4, 3)), [frozenset((0, 1))], 8)


def _featurized_cv():
    from aggforce_torch.qp.cv import fused_gb_cv
    from aggforce_torch.qp.fusedfeat import GBFeatSpec

    coords, forces, cmap = _fixture()
    fused_gb_cv(coords, forces, cmap, set(), 0.7, GBFeatSpec(outer=1.0, n_basis=2), [1e3], n_folds=2)


def _featurized_grid_cv():
    from aggforce_torch.qp.cv import fused_gb_cv_grid
    from aggforce_torch.qp.fusedfeat import GBFeatSpec

    coords, forces, cmap = _fixture()
    fused_gb_cv_grid(
        coords, forces, cmap, set(), 0.7, [GBFeatSpec(outer=1.0, n_basis=2)], [1e3],
        n_folds=2,
    )


def _batch_fits():
    from aggforce_torch import Trajectory
    from aggforce_torch.qp import GBFeatSpec, fused_gb_linear_map_batch

    coords, forces, cmap = _fixture()
    fused_gb_linear_map_batch(
        Trajectory(coords=coords, forces=forces), cmap, kbt=0.7,
        spec=GBFeatSpec(outer=1.0, n_basis=3), seeds=[0, 1],
    )


def _linear_map_carry():
    from aggforce_torch.convert import separable_map_from_numpy

    separable_map_from_numpy(np.eye(2, 6), np.eye(2, 6))


def _traj():
    from aggforce_torch import Trajectory

    coords, forces, cmap = _fixture()
    return Trajectory(coords=coords, forces=forces), cmap


def _gauss_fit():
    from aggforce_torch import joptgauss_map

    joptgauss_map(*_traj(), var=0.002, kbt=0.7, seed=1)


def _staged_gauss_fit():
    from aggforce_torch import stagedjoptgauss_map

    stagedjoptgauss_map(*_traj(), var=0.002, kbt=0.7, seed=1)


def _slice_gauss_map():
    from aggforce_torch import stagedjslicegauss_map
    from aggforce_torch.trajectory import CoordsTrajectory

    coords, _, cmap = _fixture()
    stagedjslicegauss_map(CoordsTrajectory(coords=coords), cmap, var=0.002, kbt=0.7)


def _force_gauss_fit():
    from aggforce_torch import stagedjforcegauss_map

    stagedjforcegauss_map(*_traj(), var=0.002, kbt=0.7, seed=1)


def _gauss_project_forces():
    from aggforce_torch import joptgauss_map, project_forces

    coords, forces, cmap = _fixture()
    project_forces(coords, forces, cmap, method=joptgauss_map, var=0.002, kbt=0.7)


def _augmenter():
    from aggforce_torch.trajectory import TCondNormal

    TCondNormal(cov=0.002)


def _gauss_map_carry():
    from aggforce_torch.convert import gauss_map_from_numpy

    gauss_map_from_numpy(np.eye(2, 8), np.eye(2, 8), 0.002, 0.7, premap_mat=np.eye(2, 6))


def _map_validation():
    from aggforce_torch.mapval import random_force_proj

    coords, forces, _ = _fixture()
    random_force_proj(coords, forces, n_samples=2)


def _generic_fit():
    from aggforce_torch import Trajectory, id_feat, qp_feat_linear_map

    coords, forces, cmap = _fixture()
    qp_feat_linear_map(
        Trajectory(coords=coords, forces=forces), cmap, id_feat, 0.7, allow_fused=False
    )


def _streamed_linear_fit():
    from aggforce_torch.io import TrajectoryStream, qp_linear_map_streamed

    coords, forces, cmap = _fixture()
    qp_linear_map_streamed(TrajectoryStream.from_arrays(coords, forces), cmap)


def _streamed_featurized_fit():
    from aggforce_torch.io import TrajectoryStream, fused_gb_linear_map_streamed
    from aggforce_torch.qp import GBFeatSpec

    coords, forces, cmap = _fixture()
    fused_gb_linear_map_streamed(
        TrajectoryStream.from_arrays(coords, forces), cmap, kbt=0.7,
        spec=GBFeatSpec(outer=1.0, n_basis=2),
    )


def _staging():
    from aggforce_torch.io import stage_trajectory

    coords, forces, _ = _fixture()
    stage_trajectory(coords, forces)


def _load_map(tmp_path):
    from aggforce_torch.utils.serialize import load_tmap, save_tmap

    path = str(tmp_path / "map.npz")
    save_tmap(path, _fixture()[2])
    load_tmap(path)


def _warm_up():
    from aggforce_torch.qp import GBFeatSpec
    from aggforce_torch.utils.warmup import warm_featurized_fit

    warm_featurized_fit(8, _fixture()[2], GBFeatSpec(outer=1.0, n_basis=2))


def _device_const():
    from aggforce_torch.utils.devcache import device_const

    device_const(np.ones(3))


@pytest.mark.parametrize(
    "entry",
    [_project_forces, _fused_fit, _blocked_fit, _tlinear_map, _map_carry, _gb_feat,
     _project_forces_defaults, _linear_fit, _finder, _fold_probe, _linear_cv,
     _device_synthesis, _linear_map_carry, _featurized_cv, _featurized_grid_cv,
     _batch_fits, _gauss_fit, _staged_gauss_fit, _slice_gauss_map, _force_gauss_fit,
     _gauss_project_forces, _augmenter, _gauss_map_carry, _map_validation,
     _generic_fit, _streamed_linear_fit, _streamed_featurized_fit, _staging,
     _load_map, _warm_up, _device_const],
    ids=lambda f: f.__name__.strip("_"),
)
def test_entry_points_need_cuda_unless_told(monkeypatch, tmp_path, entry):
    """device=None means the card: without CUDA it raises, never runs on CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        entry(tmp_path) if entry is _load_map else entry()
