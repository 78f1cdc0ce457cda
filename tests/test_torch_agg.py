"""Port parity: project_forces with the JAX package's defaults."""

import numpy as np
import pytest
import torch

import aggforce_torch as pt
from aggforce_torch.qp.qplinear import fit_routes
from aggforce_torch.utils.synth import synthesize_trajectory

import aggforce_tpu as jt

N_ATOMS = 60
GROUPS = {frozenset((i, i + 1)) for i in range(0, 20, 2)}
SITES = [[i] for i in range(0, N_ATOMS, 7)]


@pytest.fixture(scope="module")
def system():
    base = np.random.default_rng(5).normal(scale=0.5, size=(N_ATOMS, 3))
    return synthesize_trajectory(base, GROUPS, 400, seed=9)


@pytest.fixture(scope="module")
def results(system):
    """Both packages' project_forces with every default."""
    coords, forces = system
    expect = jt.project_forces(coords, forces, jt.LinearMap(SITES, n_fg_sites=N_ATOMS))
    fit_routes.clear()
    got = pt.project_forces(
        coords, forces, pt.LinearMap(SITES, n_fg_sites=N_ATOMS), device="cpu"
    )
    return expect, got, dict(fit_routes)


def test_auto_constraints_match_jax(results):
    expect, got, _ = results
    assert expect["constraints"] == GROUPS
    assert got["constraints"] == expect["constraints"]


def test_default_method_mapped_forces_match_jax(results):
    """The default, qp_linear_map on the device, maps forces as the JAX
    package's default does: within 1e-5 relative RMS."""
    expect, got, routes = results
    assert routes == {"device": 1}
    jf = np.asarray(expect["mapped_forces"], np.float64)
    diff = np.asarray(got["mapped_forces"], np.float64) - jf
    assert np.sqrt(np.mean(diff**2) / np.mean(jf**2)) <= 1e-5
    np.testing.assert_allclose(
        got["mapped_coords"], np.asarray(expect["mapped_coords"]), rtol=1e-6, atol=1e-6
    )
    assert got["residual"] == pytest.approx(expect["residual"], rel=1e-5)


def test_tensor_input_stays_on_its_device(system):
    """Tensors in: detection and fit on their device, tensors out."""
    coords, forces = system
    out = pt.project_forces(
        torch.as_tensor(coords), torch.as_tensor(forces),
        pt.LinearMap(SITES, n_fg_sites=N_ATOMS),
    )
    assert out["constraints"] == GROUPS
    assert isinstance(out["mapped_forces"], torch.Tensor)


def test_uniform_method_through_project_forces(system):
    coords, forces = system
    kw = dict(constrained_inds=GROUPS, method=pt.constraint_aware_uni_map)
    got = pt.project_forces(coords, forces, pt.LinearMap(SITES, n_fg_sites=N_ATOMS), **kw)
    expect = jt.project_forces(
        coords, forces, jt.LinearMap(SITES, n_fg_sites=N_ATOMS),
        constrained_inds=GROUPS, method=jt.constraint_aware_uni_map,
    )
    np.testing.assert_allclose(
        got["mapped_forces"], expect["mapped_forces"], rtol=1e-6, atol=1e-5
    )


def test_unknown_constraint_mode_raises(system):
    coords, forces = system
    with pytest.raises(ValueError, match="Unknown constraint mode"):
        pt.project_forces(
            coords, forces, pt.LinearMap(SITES, n_fg_sites=N_ATOMS),
            constrained_inds="guess", device="cpu",
        )


@pytest.mark.parametrize("tensors", [False, True], ids=["numpy", "tensor"])
def test_uniform_method_with_auto_constraints(system, tensors):
    """The uniform map through project_forces on the CPU, constraints
    detected: numpy in gives numpy out, CPU tensors give tensors, and both
    equal the JAX package's mapped forces."""
    coords, forces = system
    args = (torch.as_tensor(coords), torch.as_tensor(forces)) if tensors else (coords, forces)
    got = pt.project_forces(
        *args, pt.LinearMap(SITES, n_fg_sites=N_ATOMS),
        method=pt.constraint_aware_uni_map, device="cpu",
    )
    expect = jt.project_forces(
        coords, forces, jt.LinearMap(SITES, n_fg_sites=N_ATOMS),
        method=jt.constraint_aware_uni_map,
    )
    assert got["constraints"] == expect["constraints"] == GROUPS
    assert isinstance(got["mapped_forces"], torch.Tensor) == tensors
    np.testing.assert_allclose(
        np.asarray(got["mapped_forces"]), expect["mapped_forces"], rtol=1e-6, atol=1e-5
    )
