"""Port parity: the static linear force map against the JAX package's."""

from contextlib import contextmanager

import numpy as np
import pytest
import torch

import aggforce_torch as pt
from aggforce_torch.convert import separable_map_from_numpy
from aggforce_torch.qp import qplinear as pql
from aggforce_torch.qp.basicagg import constraint_aware_uni_map as port_uni
from aggforce_torch.utils.synth import synthesize_dimer_fixture, synthesize_trajectory

import aggforce_tpu as jt
from aggforce_tpu.qp import qplinear as jql
from aggforce_tpu.qp.basicagg import constraint_aware_uni_map as jax_uni
from aggforce_tpu.utils.synth import synthesize_dimer_fixture as jax_dimer

N_ATOMS = 60
GROUPS = {frozenset((i, i + 1)) for i in range(0, 20, 2)}
SITES = [[i] for i in range(0, N_ATOMS, 7)]


@pytest.fixture(scope="module")
def system():
    """The 60-atom synthetic system: 10 rigid pairs, 9 cg sites, 400 frames."""
    base = np.random.default_rng(5).normal(scale=0.5, size=(N_ATOMS, 3))
    return synthesize_trajectory(base, GROUPS, 400, seed=9)


@pytest.fixture(scope="module")
def dimer():
    fix = synthesize_dimer_fixture(n_frames=300)
    jfix = jax_dimer(n_frames=300)
    for key in ("coords", "forces"):
        np.testing.assert_array_equal(fix[key], jfix[key])
    return fix["coords"], fix["forces"]


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


def _fits(coords, forces, sites, n_atoms, constraints, **kw):
    """(JAX map, port map) of qp_linear_map with the same arguments."""
    jmap = jql.qp_linear_map(
        jt.Trajectory(coords=coords, forces=forces),
        jt.LinearMap(sites, n_fg_sites=n_atoms), constraints=constraints, **kw,
    )
    pmap = pql.qp_linear_map(
        pt.Trajectory(coords=coords, forces=forces),
        pt.LinearMap(sites, n_fg_sites=n_atoms), constraints=constraints,
        device="cpu", **kw,
    )
    return jmap, pmap


def _rel_rms(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.sqrt(np.mean((got - ref) ** 2) / np.mean(ref**2)))


@pytest.mark.parametrize(
    "constraints",
    [set(), GROUPS, {frozenset((1, 2)), frozenset((2, 3)), frozenset((9, 40))}],
    ids=["none", "pairs", "chained"],
)
def test_labels_and_bond_matrix_equal_jax(constraints):
    labels, r = pql.constraint_labels(N_ATOMS, constraints)
    jlabels, jr = jql.constraint_labels(N_ATOMS, constraints)
    assert r == jr
    np.testing.assert_array_equal(labels, jlabels)
    np.testing.assert_array_equal(
        pql.make_bond_constraint_matrix(N_ATOMS, constraints),
        jql.make_bond_constraint_matrix(N_ATOMS, constraints),
    )


@pytest.mark.parametrize("constraints", [set(), GROUPS], ids=["none", "pairs"])
def test_uniform_map_equals_jax(system, constraints):
    coords, forces = system
    pmap = port_uni(
        pt.Trajectory(coords=coords, forces=forces),
        pt.LinearMap(SITES, n_fg_sites=N_ATOMS), constraints=constraints,
    )
    jmap = jax_uni(
        jt.Trajectory(coords=coords, forces=forces),
        jt.LinearMap(SITES, n_fg_sites=N_ATOMS), constraints=constraints,
    )
    np.testing.assert_array_equal(
        pmap.force_map.standard_matrix, jmap.force_map.standard_matrix
    )


@pytest.mark.parametrize("l2", [0.0, 1e2])
def test_device_fit_matches_jax(system, l2):
    coords, forces = system
    jmap, pmap = _fits(
        coords, forces, SITES, N_ATOMS, GROUPS, l2_regularization=l2,
        solver_args={"backend": "device"},
    )
    fj = np.asarray(jmap.force_map.standard_matrix)
    fp = pmap.force_map.standard_matrix
    assert np.abs(fp - fj).max() <= 1e-4 * np.abs(fj).max()
    _, mj = jmap.map_arrays(coords, forces)
    _, mp = pmap.map_arrays(coords, forces)
    assert _rel_rms(mp, mj) <= 1e-5


def test_device_fit_matches_jax_on_dimer(dimer):
    """On the dimer the optimal map cancels internal forces 75x larger than
    the mapped forces, so each float32 fit's mapped forces lie ~1.6e-4
    relative RMS off the float64 host fit, in either package, and 1e-5
    between the two float32 fits is below that noise. The port must be
    as close to the float64 fit as the JAX package is (within 1.5x), and
    its F within 1e-4 max|F| of JAX's."""
    coords, forces = dimer
    jmap, pmap = _fits(coords, forces, [[0], [3]], 6, set())
    fj = np.asarray(jmap.force_map.standard_matrix)
    fp = pmap.force_map.standard_matrix
    assert np.abs(fp - fj).max() <= 1e-4 * np.abs(fj).max()
    _, host = pql.qp_linear_map(
        pt.Trajectory(coords=coords, forces=forces), pt.LinearMap([[0], [3]], n_fg_sites=6),
        solver_args={"backend": "host"},
    ).map_arrays(coords, forces)
    jax_err = _rel_rms(jmap.map_arrays(coords, forces)[1], host)
    assert _rel_rms(pmap.map_arrays(coords, forces)[1], host) <= 1.5 * jax_err
    # whole molecules aggregate, as on the reference water dimer
    np.testing.assert_allclose(fp, np.repeat(np.eye(2), 3, axis=1), atol=5e-3)


@pytest.mark.parametrize("backend", ["host"])
def test_float64_backends_match_jax(system, backend):
    """The float64 backend against the JAX package's float64 fit."""
    coords, forces = system
    jmap = jql.qp_linear_map(
        jt.Trajectory(coords=coords, forces=forces),
        jt.LinearMap(SITES, n_fg_sites=N_ATOMS), constraints=GROUPS,
        l2_regularization=1.0, solver_args={"backend": "host"},
    )
    pmap = pql.qp_linear_map(
        pt.Trajectory(coords=coords, forces=forces),
        pt.LinearMap(SITES, n_fg_sites=N_ATOMS), constraints=GROUPS,
        l2_regularization=1.0, solver_args={"backend": backend},
    )
    np.testing.assert_allclose(
        pmap.force_map.standard_matrix, jmap.force_map.standard_matrix,
        rtol=0, atol=1e-10,
    )


def test_auto_backend_takes_host_for_float64(system):
    """On the CPU, "auto" sends float64 forces to the float64 host fit, as
    the JAX package does."""
    coords, forces = system
    pql.fit_routes.clear()
    pmap = pql.qp_linear_map(
        pt.Trajectory(coords=coords.astype(np.float64), forces=forces.astype(np.float64)),
        pt.LinearMap(SITES, n_fg_sites=N_ATOMS), constraints=GROUPS, device="cpu",
    )
    assert dict(pql.fit_routes) == {"host": 1}
    assert pmap.force_map.standard_matrix.dtype == np.float64


@pytest.mark.parametrize("device", [None, "cuda"], ids=["default", "cuda"])
def test_auto_backend_keeps_float64_on_the_card(system, monkeypatch, device):
    """Off the CPU, "auto" never takes float64 forces to the host: without a
    card the fit raises instead of running there."""
    coords, forces = system
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pql.fit_routes.clear()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pql.qp_linear_map(
            pt.Trajectory(coords=coords.astype(np.float64), forces=forces.astype(np.float64)),
            pt.LinearMap(SITES, n_fg_sites=N_ATOMS), constraints=GROUPS, device=device,
        )
    assert "host" not in pql.fit_routes


def test_float64_device_fit_matches_host(system):
    """The device backend keeps float64 forces in float64 (the card's route
    for them under "auto"): one device fit, a float64 map within 3e-6
    relative RMS of the float64 host fit's mapped forces."""
    coords, forces = system
    traj = pt.Trajectory(
        coords=torch.as_tensor(coords, dtype=torch.float64),
        forces=torch.as_tensor(forces, dtype=torch.float64),
    )
    cmap = pt.LinearMap(SITES, n_fg_sites=N_ATOMS)
    pql.fit_routes.clear()
    dev = pql.qp_linear_map(traj, cmap, GROUPS, solver_args={"backend": "device"})
    assert dict(pql.fit_routes) == {"device": 1}
    assert dev.force_map.standard_matrix.dtype == np.float64
    host = pql.qp_linear_map(traj, cmap, GROUPS, solver_args={"backend": "host"})
    got, ref = dev(traj).forces.numpy(), host(traj).forces.numpy()
    assert _rel_rms(got, ref) <= 3e-6


@pytest.mark.parametrize("api", ["legacy", "new"])
def test_device_fit_is_full_fp32_under_process_tf32(system, monkeypatch, api):
    """With TF32 on for the process, the device fit's Gram and solve still
    run at full float32 precision, and the setting is back after the fit."""
    coords, forces = system
    seen = []
    solve = pql.eqp_solve_auglag

    def recording_solve(*args, **kwargs):
        seen.append(_cublas_tf32())
        return solve(*args, **kwargs)

    monkeypatch.setattr(pql, "eqp_solve_auglag", recording_solve)
    with tf32_on(api):
        before = _cublas_tf32()
        _, pmap = _fits(coords, forces, SITES, N_ATOMS, GROUPS)
        after = _cublas_tf32()
    assert before in ("high", "tf32") and after == before
    assert seen in (["highest"], ["ieee"])
    _, ref = _fits(coords, forces, SITES, N_ATOMS, GROUPS)
    np.testing.assert_array_equal(
        pmap.force_map.standard_matrix, ref.force_map.standard_matrix
    )


def test_forced_escalation_is_counted_and_equals_host(system):
    """resid_tol=0 sends the fit to the float64 host twin, and the route
    counter says so."""
    coords, forces = system
    host = pql.qp_linear_map(
        pt.Trajectory(coords=coords, forces=forces),
        pt.LinearMap(SITES, n_fg_sites=N_ATOMS), constraints=GROUPS,
        solver_args={"backend": "host"},
    )
    pql.fit_routes.clear()
    _, pmap = _fits(
        coords, forces, SITES, N_ATOMS, GROUPS, solver_args={"resid_tol": 0.0}
    )
    assert dict(pql.fit_routes) == {"device": 1, "escalated": 1}
    np.testing.assert_array_equal(
        pmap.force_map.standard_matrix, host.force_map.standard_matrix
    )


def test_tensor_input_gives_tensor_maps(system):
    coords, forces = system
    traj = pt.Trajectory(coords=torch.as_tensor(coords), forces=torch.as_tensor(forces))
    tmap = pql.qp_linear_map(traj, pt.LinearMap(SITES, n_fg_sites=N_ATOMS), GROUPS)
    assert isinstance(tmap.force_map, pt.TLinearMap)
    assert isinstance(tmap.coord_map, pt.TLinearMap)
    mapped = tmap(traj)
    assert isinstance(mapped.forces, torch.Tensor)
    _, ref = pql.qp_linear_map(
        pt.Trajectory(coords=coords, forces=forces),
        pt.LinearMap(SITES, n_fg_sites=N_ATOMS), GROUPS, device="cpu",
    ).map_arrays(coords, forces)
    np.testing.assert_allclose(mapped.forces.numpy(), ref, rtol=1e-6, atol=1e-5)


def test_reference_solver_options_are_ignored(system):
    coords, forces = system
    kw = dict(constraints=GROUPS, device="cpu")
    cmap = pt.LinearMap(SITES, n_fg_sites=N_ATOMS)
    traj = pt.Trajectory(coords=coords, forces=forces)
    plain = pql.qp_linear_map(traj, cmap, **kw)
    osqp = pql.qp_linear_map(
        traj, cmap, solver_args={"solver": "osqp", "eps_abs": 1e-7, "polish": True}, **kw
    )
    np.testing.assert_array_equal(
        plain.force_map.standard_matrix, osqp.force_map.standard_matrix
    )
    assert pql._solver_opts({"eps_abs": 1.0, "delta": 2.0}) == {
        "backend": "auto", "delta": 2.0,
    }


def test_device_gram_matches_dense_product():
    """The index_add_ reduction over frame blocks (two here, of 2,500 frames)
    equals the dense (F C)^T (F C)."""
    forces = np.random.default_rng(3).normal(size=(5000, N_ATOMS, 3))
    labels, r = pql.constraint_labels(N_ATOMS, GROUPS)
    gram = pql._linear_gram(
        torch.as_tensor(forces), torch.as_tensor(labels, dtype=torch.int64), r
    ).numpy()
    design = pt.ops.qp_form(forces.astype(np.float64)) @ pql._dense_from_labels(labels, r)
    np.testing.assert_allclose(gram, design.T @ design, rtol=1e-12, atol=1e-9)


def test_jax_fitted_linear_map_carries_over(system):
    coords, forces = system
    jmap, _ = _fits(coords, forces, SITES, N_ATOMS, GROUPS)
    pmap = separable_map_from_numpy(
        jmap.coord_map.standard_matrix, np.asarray(jmap.force_map.standard_matrix),
        device="cpu",
    )
    jc, jf = jmap.map_arrays(coords, forces)
    pc, pf = pmap.map_arrays(coords, forces)
    np.testing.assert_allclose(pf, np.asarray(jf), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(pc, np.asarray(jc), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("entry", ["qp_linear_map", "qp_feat_linear_map"])
@pytest.mark.parametrize("backend", ["native", "lu", "hsot"])
def test_unknown_backend_raises(system, entry, backend):
    """A backend other than "auto", "device" or "host" is refused by name on
    both entries, never run as the device solver."""
    coords, forces = system
    traj = pt.Trajectory(coords=coords, forces=forces)
    cmap = pt.LinearMap(SITES, n_fg_sites=N_ATOMS)
    with pytest.raises(ValueError, match="'auto', 'device', 'host'"):
        if entry == "qp_linear_map":
            pql.qp_linear_map(
                traj, cmap, GROUPS, solver_args={"backend": backend}, device="cpu"
            )
        else:
            pt.qp_feat_linear_map(
                traj, cmap, pt.id_feat, 1.0, constraints=GROUPS,
                solver_args={"backend": backend}, device="cpu",
            )


def test_mesh_raises(system):
    """``mesh`` is checked (not a mesh: TypeError) and, on one rank, the
    mesh fit is the single-device device fit bit for bit, its escalation
    included; tests/test_torch_parallel.py runs two ranks."""
    from aggforce_torch.parallel import initialize_distributed, make_mesh

    coords, forces = system
    traj = pt.Trajectory(coords=coords, forces=forces)
    cmap = pt.LinearMap(SITES, n_fg_sites=N_ATOMS)
    with pytest.raises(TypeError, match="FrameMesh"):
        pql.qp_linear_map(traj, cmap, GROUPS, mesh=object(), device="cpu")
    initialize_distributed(backend="gloo")
    try:
        mesh = make_mesh(device="cpu")
        for args in ({}, {"resid_tol": 0.0}):
            opts = {"backend": "device", **args}
            maps = [
                pql.qp_linear_map(traj, cmap, GROUPS, solver_args=opts, mesh=m, device="cpu")
                for m in (None, mesh)
            ]
            np.testing.assert_array_equal(
                maps[0].force_map.standard_matrix, maps[1].force_map.standard_matrix
            )
    finally:
        torch.distributed.destroy_process_group()
