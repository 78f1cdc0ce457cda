"""Port parity: the featurized fit end to end against the JAX package."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import aggforce_torch as pt
from aggforce_torch.convert import fused_map_from_numpy
from aggforce_torch.qp import fusedfeat as pff
from aggforce_torch.qp.feat import gb_feat as port_gb_feat
from aggforce_torch.utils.synth import synthesize_trajectory as port_synth

import aggforce_tpu as jt
import aggforce_tpu.utils  # noqa: F401 - Curry for the JAX featurizer
from aggforce_tpu.qp import fusedfeat as jff
from aggforce_tpu.qp.jaxfeat import gb_feat as jax_gb_feat
from aggforce_tpu.trajectory import Trajectory as JTrajectory
from aggforce_tpu.utils.synth import synthesize_trajectory as jax_synth

KBT = 0.7
L2 = 1e3
N_ATOMS = 24
GROUPS = [frozenset((i, i + 1)) for i in range(0, 8, 2)]
SITES = [[i] for i in range(0, N_ATOMS, 9)]


@pytest.fixture(scope="module")
def system():
    base = np.random.default_rng(0).normal(scale=0.5, size=(N_ATOMS, 3))
    coords, forces = port_synth(base, GROUPS, 256, seed=3)
    jc, jf = jax_synth(base, GROUPS, 256, seed=3)
    np.testing.assert_array_equal(coords, jc)
    np.testing.assert_array_equal(forces, jf)
    return coords, forces


def _featurizer(package, outer=2.0, n_basis=4):
    gb = package.qp.gb_feat
    return package.qp.Multifeaturize(
        [package.qp.id_feat, package.utils.Curry(gb, outer=outer, n_basis=n_basis)]
    )


def _jax_fit(coords, forces, **kw):
    return jff.fused_gb_linear_map(
        JTrajectory(coords=coords, forces=forces),
        jt.LinearMap(SITES, n_fg_sites=N_ATOMS),
        kbt=KBT, spec=jff.GBFeatSpec(outer=2.0, n_basis=4),
        constraints=set(GROUPS), l2_regularization=L2, n_constraint_frames=10,
        constraint_rng=np.random.default_rng(7), **kw,
    )


def _port_fit(coords, forces, **kw):
    return pff.fused_gb_linear_map(
        pt.Trajectory(coords=coords, forces=forces),
        pt.LinearMap(SITES, n_fg_sites=N_ATOMS),
        kbt=KBT, spec=pff.GBFeatSpec(outer=2.0, n_basis=4),
        constraints=set(GROUPS), l2_regularization=L2, n_constraint_frames=10,
        constraint_rng=np.random.default_rng(7), device="cpu", **kw,
    )


def test_group_feature_blocks_match_jax(system):
    coords, _ = system
    cmap = pt.LinearMap(SITES, n_fg_sites=N_ATOMS)
    spec = pff.GBFeatSpec(outer=2.0, n_basis=4)
    geom = pff.group_factorization(cmap, spec, set(GROUPS))
    jgeom = jff.group_factorization(
        jt.LinearMap(SITES, n_fg_sites=N_ATOMS), jff.GBFeatSpec(outer=2.0, n_basis=4),
        set(GROUPS),
    )
    for key in geom:
        np.testing.assert_array_equal(geom[key], jgeom[key])
    cg = cmap(coords).astype(np.float32)
    arrays = (coords[:32], cg[:32], geom["group_mean"], geom["counts"], geom["centers"])
    expect = jff._group_feature_blocks(
        *map(jnp.asarray, arrays), jff.GBFeatSpec(outer=2.0, n_basis=4)
    )
    got = pff._group_feature_blocks(*map(torch.as_tensor, arrays), spec)
    for e, g in zip(expect, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(e), rtol=1e-5, atol=1e-6)


def test_gb_feat_matches_jax(system):
    coords, _ = system
    kw = dict(outer=2.0, n_basis=4, lazy=False, batch_size=24)
    expect = jax_gb_feat(coords[:50], jt.LinearMap(SITES, n_fg_sites=N_ATOMS), set(GROUPS), **kw)
    got = port_gb_feat(
        coords[:50], pt.LinearMap(SITES, n_fg_sites=N_ATOMS), set(GROUPS),
        device="cpu", **kw,
    )
    for key in ("feats", "divs"):
        for e, g in zip(expect[key], got[key]):
            assert isinstance(g, np.ndarray)
            np.testing.assert_allclose(g, np.asarray(e), rtol=1e-5, atol=1e-5)


def test_project_forces_matches_jax_fit(system):
    """The whole main path, through project_forces, against the JAX fit."""
    coords, forces = system
    result = pt.project_forces(
        coords, forces, pt.LinearMap(SITES, n_fg_sites=N_ATOMS),
        constrained_inds=set(GROUPS), method=pt.qp_feat_linear_map,
        featurizer=_featurizer(pt), kbt=KBT, l2_regularization=L2,
        n_constraint_frames=10, constraint_rng=np.random.default_rng(7),
        device="cpu",
    )
    jmap = _jax_fit(coords, forces)
    jc, jf = jmap.map_arrays(coords, forces)
    scale = np.abs(jf).mean()
    np.testing.assert_allclose(result["mapped_forces"], jf, atol=2e-3 * scale)
    np.testing.assert_allclose(result["mapped_coords"], jc, rtol=1e-6, atol=1e-6)
    assert result["tmap"].force_map.tags["solver_resid"] <= 1e-4
    assert result["residual"] == pytest.approx(float(np.mean(jf**2)), rel=1e-3)


def test_forced_escalation_matches_jax(system):
    """resid_tol below the float32 floor sends every site to the float64
    host oracle in both packages."""
    coords, forces = system
    jmap = _jax_fit(coords, forces, resid_tol=1e-12)
    pmap = _port_fit(coords, forces, resid_tol=1e-12)
    assert pmap.force_map.tags["escalated"]
    assert pmap.force_map.tags["solver_resid"] <= 1e-6
    _, jf = jmap.map_arrays(coords, forces)
    _, pf = pmap.map_arrays(coords, forces)
    np.testing.assert_allclose(pf, jf, atol=2e-3 * np.abs(jf).mean())


def test_jax_fitted_map_carries_over(system):
    """A map fitted by the JAX package, rebuilt from its arrays, maps forces
    exactly as the JAX map does."""
    coords, forces = system
    jmap = _jax_fit(coords, forces)
    spec = jff.GBFeatSpec(outer=2.0, n_basis=4)
    geom = jff.group_factorization(
        jt.LinearMap(SITES, n_fg_sites=N_ATOMS), spec, set(GROUPS)
    )
    pmap = fused_map_from_numpy(
        jmap.force_map.tags["coef_list"], jmap.coord_map.standard_matrix,
        geom["onehot"], geom["centers"], KBT, dataclasses.asdict(spec),
        device="cpu",
    )
    jc, jf = jmap.map_arrays(coords, forces)
    pc, pf = pmap.map_arrays(coords, forces)
    np.testing.assert_allclose(pf, np.asarray(jf), atol=1e-4 * np.abs(jf).mean())
    np.testing.assert_allclose(pc, np.asarray(jc), rtol=1e-6, atol=1e-6)


def test_fused_map_scale_trans_and_tensor_apply(system):
    """The CLAMap scale/trans closures and the fused apply agree; tensors in
    give tensors out."""
    coords, forces = system
    fmap = _port_fit(coords, forces).force_map
    fused = fmap(forces[:40], coords[:40])
    generic = np.einsum("tsj,tjd->tsd", fmap.scale(coords[:40]), forces[:40])
    np.testing.assert_allclose(
        generic + fmap.trans(coords[:40]), fused, rtol=1e-4, atol=1e-4
    )
    out = fmap(torch.as_tensor(forces[:40]), torch.as_tensor(coords[:40]))
    assert isinstance(out, torch.Tensor)
    np.testing.assert_allclose(out.numpy(), fused, rtol=1e-6, atol=1e-6)


def test_recognizes_only_the_port_featurizer(system):
    coords, forces = system
    assert pff.recognize_canonical_featurizer(_featurizer(pt)) == pff.GBFeatSpec(
        outer=2.0, n_basis=4
    )
    # the JAX package's gb_feat is another function: the port takes the
    # generic protocol path with it, and lands on the JAX generic fit
    foreign = pt.qp.Multifeaturize(
        [pt.qp.id_feat, pt.utils.Curry(jax_gb_feat, outer=2.0, n_basis=4)]
    )
    assert pff.recognize_canonical_featurizer(foreign) is None
    kw = dict(
        constraints=set(GROUPS), l2_regularization=L2, n_constraint_frames=10,
        constraint_rng=np.random.default_rng(7),
    )
    port = pt.qp_feat_linear_map(
        pt.Trajectory(coords=coords, forces=forces),
        pt.LinearMap(SITES, n_fg_sites=N_ATOMS), foreign, KBT, device="cpu", **kw,
    )
    assert not isinstance(port.force_map, pff.FusedGBMap)
    jax = jt.qp.qp_feat_linear_map(
        JTrajectory(coords=coords, forces=forces),
        jt.LinearMap(SITES, n_fg_sites=N_ATOMS),
        jt.qp.Multifeaturize(
            [jt.qp.id_feat, jt.utils.Curry(jax_gb_feat, outer=2.0, n_basis=4)]
        ),
        KBT, allow_fused=False, **kw,
    )
    _, jf = jax.map_arrays(coords[:64], forces[:64])
    np.testing.assert_allclose(
        port.map_arrays(coords[:64], forces[:64])[1], np.asarray(jf),
        atol=2e-3 * np.abs(jf).mean(),
    )


def test_use_kernel_true_needs_the_card(system):
    coords, forces = system
    with pytest.raises(ValueError, match="CUDA"):
        _port_fit(coords, forces, use_kernel=True)


def test_plain_gram_fit_equals_auto_fit_on_cpu(system):
    """On the CPU, "auto" runs the wrapper's plain twin: the same fit as
    use_kernel=False up to the frame chunking of the sum."""
    coords, forces = system
    auto = _port_fit(coords, forces).map_arrays(coords, forces)[1]
    plain = _port_fit(coords, forces, use_kernel=False, chunk_size=64)
    np.testing.assert_allclose(
        plain.map_arrays(coords, forces)[1], auto, atol=2e-3 * np.abs(auto).mean()
    )


def test_config3_objective_matches_jax():
    """At config-#3 width (175 atoms, 30 pairs, S = 10, n_basis = 7,
    l2 = 1e3; T = 512) the port's fit and the JAX fit are both optimal for
    the constraint values they meet, and reach the same objective.

    J(c) = sum_s c_s^T P_s c_s with P the float64 Gram + l2. Each fit's
    witness minimizes J in float64 on the host for the fit's own A c; its
    gap (J(c) - J(witness)) / J(witness) must be <= 1e-4, and the port's J
    must lie within 1e-4 relative of JAX's. The mapped forces are not
    compared: the 200 sampled constraint rows of a site are near-dependent,
    so two optimal fits part by ~1e-2 * mean|f| at the worst frame.
    """
    from aggforce_torch.ops.eqp import eqp_solve_host
    from aggforce_torch.ops.gram import site_grams_plain

    n, t, kbt = 175, 512, 0.6955215
    base = np.random.default_rng(0).normal(scale=0.5, size=(n, 3))
    groups = [frozenset((i, i + 1)) for i in range(0, 60, 2)]
    sites = [[i] for i in range(0, n, 18)]
    coords, forces = port_synth(base, groups, t, seed=2024)
    kw = dict(kbt=kbt, constraints=set(groups), l2_regularization=L2)
    jmap = jff.fused_gb_linear_map(
        JTrajectory(coords=coords, forces=forces), jt.LinearMap(sites, n_fg_sites=n),
        spec=jff.GBFeatSpec(outer=8.0, n_basis=7, width=1.0),
        constraint_rng=np.random.default_rng(7), **kw,
    )
    cmap = pt.LinearMap(sites, n_fg_sites=n)
    spec = pff.GBFeatSpec(outer=8.0, n_basis=7, width=1.0)
    pmap = pff.fused_gb_linear_map(
        pt.Trajectory(coords=coords, forces=forces), cmap, spec=spec,
        constraint_rng=np.random.default_rng(7), device="cpu", **kw,
    )

    geom = pff.group_factorization(cmap, spec, set(groups))
    frame_idx = np.random.default_rng(7).choice(t, size=20, replace=False)

    def f64(x):
        return torch.as_tensor(np.asarray(x), dtype=torch.float64)

    xyz = f64(coords)
    gram, rows, _ = pff._fit_parts(
        xyz, f64(forces), torch.ones(t, dtype=torch.float64),
        xyz[torch.as_tensor(frame_idx)], f64(cmap.standard_matrix),
        f64(geom["group_mean"]), f64(geom["onehot"]), f64(geom["counts"]),
        f64(geom["centers"]), kbt, L2, spec, site_grams_plain,
    )
    gram, rows = gram.numpy(), rows.numpy()

    def objective(c):
        return float(np.einsum("si,sij,sj->", c, gram, c))

    def gap(c):
        target = np.einsum("smn,sn->sm", rows, c)
        witness = np.stack([
            eqp_solve_host(gram[s], rows[s], target[s][:, None])[:, 0]
            for s in range(gram.shape[0])
        ])
        return (objective(c) - objective(witness)) / objective(witness)

    c_jax = np.stack([np.asarray(c) for c in jmap.force_map.tags["coef_list"]])
    c_port = np.stack(pmap.force_map.tags["coef_list"])
    c_jax, c_port = c_jax.astype(np.float64), c_port.astype(np.float64)
    assert gap(c_jax) <= 1e-4
    assert gap(c_port) <= 1e-4
    assert objective(c_port) == pytest.approx(objective(c_jax), rel=1e-4)
