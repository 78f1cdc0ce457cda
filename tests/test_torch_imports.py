"""The PyTorch port stands alone: no JAX, no JAX package, GPU by default."""

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
        "aggforce_torch.qp.fusedfeat, aggforce_torch.utils.synth\n"
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


@pytest.mark.parametrize(
    "path",
    sorted(PORT.rglob("*.py")) + [REPO_ROOT / "chip_smoke.py"],
    ids=lambda p: str(p.relative_to(REPO_ROOT)),
)
def test_sources_do_not_import_jax(path):
    text = path.read_text()
    assert not IMPORT_RE.search(text)
    if path.is_relative_to(PORT):
        # the package names its JAX counterparts in prose, never by package
        assert "aggforce_tpu" not in text


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


@pytest.mark.parametrize(
    "entry",
    [_project_forces, _fused_fit, _blocked_fit, _tlinear_map, _map_carry, _gb_feat],
    ids=lambda f: f.__name__.strip("_"),
)
def test_entry_points_need_cuda_unless_told(monkeypatch, entry):
    """device=None means the card: without CUDA it raises, never runs on CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        entry()
