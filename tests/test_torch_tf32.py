"""Full float32 under a process-wide TF32 switch: every product of the
featurized paths, the Gaussian maps, the map validation, the map
applications and the mesh fits (on a world-size-1 gloo group made and
destroyed per call) runs with TF32 off (the JAX
package's ``precision="highest"``), whichever of torch's two switches the
process used, and the switch is back afterwards."""

from contextlib import contextmanager

import numpy as np
import pytest
import torch

import aggforce_torch as pt
from aggforce_torch import parallel as par
from aggforce_torch.ops import eqp as peqp
from aggforce_torch.ops import gram as pgram
from aggforce_torch.ops.torchcore import trjdot
from aggforce_torch.qp import cv as pcv
from aggforce_torch.qp import fusedfeat as pff
from aggforce_torch.utils.synth import synthesize_trajectory

KBT = 0.7
N_ATOMS = 24
GROUPS = {frozenset((i, i + 1)) for i in range(0, 8, 2)}
SITES = [[i] for i in range(0, N_ATOMS, 9)]
SPEC = pff.GBFeatSpec(outer=2.0, n_basis=4)
FULL = ("highest", "ieee")


@contextmanager
def tf32_on(api):
    """TF32 products allowed for the whole process, through torch's legacy
    switch or its newer one; the default (off) is restored on exit."""
    matmul = torch.backends.cuda.matmul
    try:
        if api == "legacy":
            torch.set_float32_matmul_precision("high")
        else:
            matmul.fp32_precision = "tf32"
        yield
    finally:
        if api == "legacy":
            torch.set_float32_matmul_precision("highest")
        else:
            matmul.fp32_precision = "ieee"


def _cublas_tf32() -> str:
    """The process's TF32 setting for cuBLAS float32 products."""
    try:
        return torch.get_float32_matmul_precision()
    except RuntimeError:  # the newer switch is in use
        return torch.backends.cuda.matmul.fp32_precision


@pytest.fixture(scope="module")
def system():
    base = np.random.default_rng(0).normal(scale=0.5, size=(N_ATOMS, 3))
    coords, forces = synthesize_trajectory(base, GROUPS, 96, seed=3)
    return coords, forces


def _fit(coords, forces, **kw):
    return pff.fused_gb_linear_map(
        pt.Trajectory(coords=coords, forces=forces), pt.LinearMap(SITES, n_fg_sites=N_ATOMS),
        kbt=KBT, spec=SPEC, constraints=GROUPS, l2_regularization=1e3,
        n_constraint_frames=6, constraint_rng=np.random.default_rng(1), device="cpu", **kw,
    )


@contextmanager
def _one_rank():
    """A world-size-1 gloo group's CPU mesh, the group destroyed on exit."""
    par.initialize_distributed(backend="gloo")
    try:
        yield par.make_mesh(device="cpu")
    finally:
        torch.distributed.destroy_process_group()


def _mesh_fit(coords, forces):
    with _one_rank() as mesh:
        return _fit(coords, forces, mesh=mesh).force_map._coefs


def _mesh_batch_fits(coords, forces):
    with _one_rank() as mesh:
        return _batch_fits(coords, forces, mesh=mesh)


def _mesh_linear_fit(coords, forces):
    with _one_rank() as mesh:
        tmap = pt.qp_linear_map(
            pt.Trajectory(coords=coords, forces=forces), pt.LinearMap(SITES, n_fg_sites=N_ATOMS),
            GROUPS, mesh=mesh, device="cpu",
        )
    return torch.as_tensor(tmap.force_map.standard_matrix)


def _mesh_staged_gauss(coords, forces):
    with _one_rank() as mesh:
        return _staged_gauss(coords, forces, mesh=mesh)


def _pack(coords, forces):
    geom = pff.group_factorization(pt.LinearMap(SITES, n_fg_sites=N_ATOMS), SPEC, GROUPS)
    f32 = [torch.as_tensor(x, dtype=torch.float32) for x in (
        coords, forces, np.ones(len(coords)), pt.LinearMap(SITES, n_fg_sites=N_ATOMS).standard_matrix,
        geom["group_mean"], geom["onehot"], geom["counts"],
    )]
    return pgram.pack_operands(*f32, KBT, SPEC.n_basis, torch.as_tensor(geom["centers"]))


def _cv(coords, forces):
    table = pcv.fused_gb_cv(
        coords, forces, pt.LinearMap(SITES, n_fg_sites=N_ATOMS), GROUPS, KBT, SPEC,
        [1e3], n_folds=3, n_constraint_frames=5, rng=np.random.default_rng(2), device="cpu",
    )
    return torch.tensor(table[1e3][:2])


def _batch_solve(coords, forces):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(3, 30, 10))
    P = torch.as_tensor(np.einsum("sti,stj->sij", x, x) + 0.1 * np.eye(10), dtype=torch.float32)
    A = torch.as_tensor(rng.normal(size=(4, 3, 4, 10)), dtype=torch.float32)
    B = torch.as_tensor(rng.normal(size=(4, 3, 4, 1)), dtype=torch.float32)
    return peqp.batched_eqp_solve_shared(P, A, B, iters=40, host_checks=False)


def _batch_fits(coords, forces, **kw):
    maps = pff.fused_gb_linear_map_batch(
        pt.Trajectory(coords=coords, forces=forces), pt.LinearMap(SITES, n_fg_sites=N_ATOMS),
        kbt=KBT, spec=SPEC, seeds=[1, 2], constraints=GROUPS, l2_regularization=1e3,
        n_constraint_frames=6, device="cpu", **kw,
    )
    return torch.stack([m.force_map._coefs for m in maps])


def _trjdot(coords, forces):
    factor = torch.as_tensor(np.random.default_rng(4).normal(size=(3, N_ATOMS)), dtype=torch.float32)
    return trjdot(torch.as_tensor(forces), factor)


def _fused_map(coords, forces, fitted={}):
    if "map" not in fitted:
        fitted["map"] = _fit(coords, forces).force_map
    fmap = fitted["map"]
    return torch.cat([
        fmap(torch.as_tensor(forces), torch.as_tensor(coords)).reshape(-1),
        torch.as_tensor(fmap.scale(coords)).reshape(-1),
        torch.as_tensor(fmap.trans(coords)).reshape(-1),
    ])


def _gauss_traj(coords, forces):
    return pt.Trajectory(coords=torch.as_tensor(coords), forces=torch.as_tensor(forces))


def _gauss_fit(coords, forces):
    tmap = pt.joptgauss_map(
        _gauss_traj(coords, forces), pt.LinearMap(SITES, n_fg_sites=N_ATOMS),
        var=0.002, kbt=KBT, constraints=GROUPS, seed=5,
    )
    return torch.as_tensor(tmap.tmap.force_map.standard_matrix)


def _staged_gauss(coords, forces, **kw):
    tmap = pt.stagedjoptgauss_map(
        _gauss_traj(coords, forces), pt.LinearMap(SITES, n_fg_sites=N_ATOMS),
        var=0.002, kbt=KBT, constraints=GROUPS, seed=6, **kw,
    )
    return tuple(
        torch.as_tensor(m.standard_matrix) for m in (tmap[1].force_map, tmap[0].tmap.force_map)
    )


def _gauss_apply(coords, forces, fitted={}):
    traj = _gauss_traj(coords, forces)
    if "map" not in fitted:
        fitted["map"] = pt.joptgauss_map(
            traj, pt.LinearMap(SITES, n_fg_sites=N_ATOMS), var=0.002, kbt=KBT,
            constraints=GROUPS, seed=7,
        )
    fitted["map"].augmenter._gens.clear()  # the same draw on every call
    out = fitted["map"](traj)
    return out.coords, out.forces


def _map_validation(coords, forces):
    from aggforce_torch import mapval

    return torch.tensor(mapval.random_force_proj(
        coords, forces, n_samples=5, randg=np.random.default_rng(1), average=False,
        device="cpu", inner=0.2, outer=1.2, width=0.5,
    ))


PATHS = {
    "pack_operands": _pack,
    "featurized fit": lambda c, f: _fit(c, f).force_map._coefs,
    "featurized CV": _cv,
    "batch solve": _batch_solve,
    "batch fits": _batch_fits,
    "trjdot": _trjdot,
    "FusedGBMap": _fused_map,
    "Gaussian fit": _gauss_fit,
    "staged Gaussian fit": _staged_gauss,
    "Gaussian map application": _gauss_apply,
    "map validation": _map_validation,
    "mesh featurized fit": _mesh_fit,
    "mesh batch fits": _mesh_batch_fits,
    "mesh linear fit": _mesh_linear_fit,
    "mesh staged Gaussian fit": _mesh_staged_gauss,
}


@pytest.mark.parametrize("api", ["legacy", "new"])
@pytest.mark.parametrize("path", sorted(PATHS), ids=lambda p: p.replace(" ", "-"))
def test_products_are_full_fp32_under_process_tf32(system, monkeypatch, path, api):
    """Every einsum and matmul on the path sees TF32 off while the process
    has it on; the outputs are those of a run with TF32 off; the process's
    setting is back afterwards."""
    coords, forces = system
    ref = PATHS[path](coords, forces)
    seen = []

    def recording(fn):
        def wrapper(*args, **kwargs):
            seen.append(_cublas_tf32())
            return fn(*args, **kwargs)

        return wrapper

    monkeypatch.setattr(torch, "einsum", recording(torch.einsum))
    monkeypatch.setattr(torch, "matmul", recording(torch.matmul))
    with tf32_on(api):
        before = _cublas_tf32()
        out = PATHS[path](coords, forces)
        after = _cublas_tf32()
    assert before in ("high", "tf32") and after == before
    assert seen and set(seen) <= set(FULL), sorted(set(seen))
    outs = out if isinstance(out, tuple) else (out,)
    refs = ref if isinstance(ref, tuple) else (ref,)
    for o, r in zip(outs, refs):
        torch.testing.assert_close(o, r, rtol=0, atol=0)
