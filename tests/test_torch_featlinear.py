"""Port parity: the generic featurizer protocol path of qp_feat_linear_map and
gb_feat's autodiff divergence methods, against the JAX package."""

import numpy as np
import pytest
import torch

import aggforce_torch as pt
from aggforce_torch.qp.feat import gb_feat as port_gb_feat
from aggforce_torch.qp.fusedfeat import FusedGBMap, GBFeatSpec, fused_gb_linear_map
from aggforce_torch.qp.fusedfeat import group_factorization

import aggforce_tpu as jt
import aggforce_tpu.qp  # noqa: F401 - the JAX package's protocol path
import aggforce_tpu.utils  # noqa: F401
from aggforce_tpu.qp.jaxfeat import gb_feat as jax_gb_feat

KBT = 0.5
# the l2 of the other featurized parity tests: well regularized, so the
# float32 Grams' summation order (XLA's against torch's) moves the float64
# host solve by ~1e-7 relative (at l2 = 1 it moves it by ~3e-5)
L2 = 1e3
CONSTRAINTS = {frozenset({1, 2}), frozenset({5, 6})}


@pytest.fixture(scope="module")
def small_system():
    rng = np.random.default_rng(77)
    coords = rng.normal(size=(120, 8, 3)).astype(np.float32) * 0.3
    forces = rng.normal(size=(120, 8, 3)).astype(np.float32)
    return coords, forces


def _maps():
    return pt.LinearMap([[0], [4]], n_fg_sites=8), jt.LinearMap([[0], [4]], n_fg_sites=8)


def _featurizers(outer=1.0, n_basis=4):
    port = pt.Multifeaturize(
        [pt.id_feat, pt.Curry(port_gb_feat, outer=outer, n_basis=n_basis, device="cpu")]
    )
    jax = jt.qp.Multifeaturize(
        [jt.qp.id_feat, jt.utils.Curry(jax_gb_feat, outer=outer, n_basis=n_basis)]
    )
    return port, jax


def _generic_fits(coords, forces, port_feat, jax_feat, backend, seed=0, **kw):
    pcmap, jcmap = _maps()
    kw = dict(
        kbt=KBT, constraints=CONSTRAINTS, l2_regularization=L2,
        n_constraint_frames=10, solver_args={"backend": backend}, **kw,
    )
    port = pt.qp_feat_linear_map(
        pt.Trajectory(coords=coords, forces=forces), pcmap, featurizer=port_feat,
        constraint_rng=np.random.default_rng(seed), allow_fused=False, device="cpu",
        **kw,
    )
    jax = jt.qp.qp_feat_linear_map(
        jt.Trajectory(coords=coords, forces=forces), jcmap, featurizer=jax_feat,
        constraint_rng=np.random.default_rng(seed), allow_fused=False, **kw,
    )
    return port, jax


@pytest.mark.parametrize("backend", ["host", "device"])
def test_generic_path_matches_jax(small_system, backend):
    """allow_fused=False with Multifeaturize([id_feat, gb_feat]): the host
    backend's coefficients within 1e-6 relative of JAX's, the device
    backend's mapped forces within 2e-3 * mean|f|."""
    coords, forces = small_system
    port, jax = _generic_fits(coords, forces, *_featurizers(), backend)
    assert not isinstance(port.force_map, FusedGBMap)
    pc = np.stack(port.force_map.tags["coef_list"])
    jc = np.stack(jax.force_map.tags["coef_list"])
    _, pf = port.map_arrays(coords, forces)
    _, jf = jax.map_arrays(coords, forces)
    if backend == "host":
        assert np.abs(pc - jc).max() <= 1e-6 * np.abs(jc).max()
    np.testing.assert_allclose(pf, np.asarray(jf), atol=2e-3 * np.abs(jf).mean())


@pytest.mark.parametrize("backend", ["host", "device"])
def test_id_feat_matches_linear_map(small_system, backend):
    """id_feat alone is the constrained linear map (l2 = 0)."""
    coords, forces = small_system
    pcmap, _ = _maps()
    traj = pt.Trajectory(coords=coords, forces=forces)
    lin = pt.qp_linear_map(
        traj, pcmap, constraints=CONSTRAINTS, solver_args={"backend": "host"},
        device="cpu",
    )
    feat = pt.qp_feat_linear_map(
        traj, pcmap, featurizer=pt.id_feat, kbt=KBT, constraints=CONSTRAINTS,
        l2_regularization=0.0, n_constraint_frames=10,
        solver_args={"backend": backend}, constraint_rng=np.random.default_rng(0),
        device="cpu",
    )
    _, lin_forces = lin.map_arrays(coords, forces)
    _, feat_forces = feat.map_arrays(coords, forces)
    np.testing.assert_allclose(lin_forces, feat_forces, atol=2e-3)


def test_fused_matches_protocol(small_system):
    """The fused device fit against the protocol (host-oracle) fit, every
    frame a constraint frame (the JAX package's test_fused_matches_protocol)."""
    coords, forces = small_system
    pcmap, _ = _maps()
    traj = pt.Trajectory(coords=coords, forces=forces)
    spec = GBFeatSpec(outer=1.0, n_basis=4)
    port_feat, _ = _featurizers()
    kw = dict(
        kbt=KBT, constraints=CONSTRAINTS, l2_regularization=1.0,
        constraint_rng=np.random.default_rng(42), n_constraint_frames=len(coords),
    )
    proto = pt.qp_feat_linear_map(
        traj, pcmap, featurizer=port_feat, solver_args={"backend": "host"},
        device="cpu", **kw,
    )
    fused = fused_gb_linear_map(traj, pcmap, spec=spec, device="cpu", **kw)
    _, f_proto = proto.map_arrays(coords[:30], forces[:30])
    _, f_fused = fused.map_arrays(coords[:30], forces[:30])
    np.testing.assert_allclose(f_fused, f_proto, atol=1e-2 * np.abs(f_proto).mean())


def _user_featurizer(points, cmap, constraints):
    """A featurizer neither package recognizes: id features and a smooth
    radial weight of each atom's distance to the site, with its divergence."""
    ids = pt.id_feat(points, cmap, constraints, return_ids=True)
    n_types = int(ids.max()) + 1
    onehot = np.eye(n_types, dtype=np.float32)[ids]
    feats, divs = [], []
    for site in range(cmap.n_cg_sites):
        cg = np.einsum("j,tjd->td", cmap.standard_matrix[site], points)
        disp = points - cg[:, None, :]
        radial = np.exp(-np.sum(disp**2, axis=-1))  # (T, N)
        feat = np.concatenate(
            [np.broadcast_to(onehot, points.shape[:2] + onehot.shape[1:]),
             radial[..., None] * onehot], axis=2,
        ).astype(np.float32)
        div_rad = np.einsum("tj,tjd,jg->tgd", -2.0 * radial, disp, onehot)
        div = np.concatenate(
            [np.zeros((points.shape[0], n_types, 3)), div_rad], axis=1
        ).astype(np.float32)
        feats.append(feat)
        divs.append(div)
    return {"feats": feats, "divs": divs, "names": None}


def test_user_featurizer_runs_the_generic_path(small_system):
    """A user-written featurizer is not canonical: the default call takes the
    protocol path and gives JAX's coefficients (host backend, 1e-6)."""
    coords, forces = small_system
    pcmap, jcmap = _maps()
    assert pt.qp.fusedfeat.recognize_canonical_featurizer(_user_featurizer) is None
    kw = dict(kbt=KBT, constraints=CONSTRAINTS, l2_regularization=L2, n_constraint_frames=10)
    port = pt.qp_feat_linear_map(
        pt.Trajectory(coords=coords, forces=forces), pcmap, _user_featurizer,
        constraint_rng=np.random.default_rng(3), solver_args={"backend": "host"},
        device="cpu", **kw,
    )
    jax = jt.qp.qp_feat_linear_map(
        jt.Trajectory(coords=coords, forces=forces), jcmap, _user_featurizer,
        constraint_rng=np.random.default_rng(3), solver_args={"backend": "host"}, **kw,
    )
    pc = np.stack(port.force_map.tags["coef_list"])
    jc = np.stack(jax.force_map.tags["coef_list"])
    assert np.abs(pc - jc).max() <= 1e-6 * np.abs(jc).max()
    # the default device backend lands on the same map
    dev = pt.qp_feat_linear_map(
        pt.Trajectory(coords=coords, forces=forces), pcmap, _user_featurizer,
        constraint_rng=np.random.default_rng(3), device="cpu", **kw,
    )
    _, jf = jax.map_arrays(coords, forces)
    np.testing.assert_allclose(
        dev.map_arrays(coords, forces)[1], np.asarray(jf), atol=2e-3 * np.abs(jf).mean()
    )


def test_generic_map_satisfies_sampled_orthogonality(small_system):
    coords, forces = small_system
    pcmap, _ = _maps()
    tmap = pt.qp_feat_linear_map(
        pt.Trajectory(coords=coords, forces=forces), pcmap,
        featurizer=_featurizers()[0], kbt=KBT, constraints=CONSTRAINTS,
        l2_regularization=1.0, constraint_rng=np.random.default_rng(0),
        solver_args={"backend": "host"}, device="cpu",
    )
    scale = tmap.force_map.scale(coords[:5])
    proj = np.einsum("cj,tsj->tsc", pcmap.standard_matrix, scale)
    np.testing.assert_allclose(proj, np.broadcast_to(np.eye(2), (5, 2, 2)), atol=1e-3)


def test_generic_map_applies_the_kbt_divergence(small_system):
    """The protocol map's apply path carries kbt on the divergence term: it
    maps forces as the FusedGBMap of the same coefficients does."""
    coords, forces = small_system
    pcmap, _ = _maps()
    tmap = pt.qp_feat_linear_map(
        pt.Trajectory(coords=coords, forces=forces), pcmap,
        featurizer=_featurizers()[0], kbt=KBT, constraints=CONSTRAINTS,
        l2_regularization=L2, constraint_rng=np.random.default_rng(0),
        device="cpu",
    )
    spec = GBFeatSpec(outer=1.0, n_basis=4)
    geom = group_factorization(pcmap, spec, CONSTRAINTS)
    fused = FusedGBMap(
        coefs=np.stack(tmap.force_map.tags["coef_list"]).astype(np.float32),
        cmap_mat=np.asarray(pcmap.standard_matrix, dtype=np.float32),
        onehot=geom["onehot"], centers=geom["centers"], kbt=KBT, spec=spec,
        device="cpu",
    )
    _, generic = tmap.map_arrays(coords[:40], forces[:40])
    np.testing.assert_allclose(
        fused(forces[:40], coords[:40]), generic, rtol=1e-4,
        atol=1e-4 * np.abs(generic).max(),
    )


@pytest.fixture
def one_rank_mesh():
    """A world-size-1 gloo group and its CPU mesh, destroyed after the test."""
    from aggforce_torch.parallel import initialize_distributed, make_mesh

    initialize_distributed(backend="gloo")
    try:
        yield make_mesh(device="cpu")
    finally:
        torch.distributed.destroy_process_group()


def test_generic_path_mesh_raises(small_system, one_rank_mesh):
    """The generic protocol path ignores a mesh, as the JAX package's does
    (featlinearmap.py:215-218): with one it gives the single-device map,
    bit for bit. A mesh argument that is not a mesh still raises."""
    coords, forces = small_system
    traj = pt.Trajectory(coords=coords, forces=forces)
    with pytest.raises(TypeError, match="FrameMesh"):
        pt.qp_feat_linear_map(
            traj, _maps()[0], _user_featurizer, KBT, allow_fused=False, mesh=object(),
            device="cpu",
        )
    maps = [
        pt.qp_feat_linear_map(
            traj, _maps()[0], _user_featurizer, KBT, allow_fused=False,
            constraint_rng=np.random.default_rng(2), mesh=mesh, device="cpu",
        )
        for mesh in (None, one_rank_mesh)
    ]
    np.testing.assert_array_equal(
        maps[0].map_arrays(coords, forces)[1], maps[1].map_arrays(coords, forces)[1]
    )


# every cg atom constrained to a partner: the smeared position then differs
# from the cg point, so the autodiff methods (which give NaN at coincident
# points, as the reference does) stay finite
PARTNERED = {frozenset({0, 3}), frozenset({4, 7}), frozenset({1, 2})}


def _divs(package, coords, method, constraints=PARTNERED, batch_size=None):
    port = package is pt
    gb = port_gb_feat if port else jax_gb_feat
    cmap = _maps()[0 if port else 1]
    extra = {"device": "cpu"} if port else {}
    out = gb(
        coords, cmap, constraints, outer=1.0, n_basis=4, lazy=False,
        div_method=method, batch_size=batch_size, **extra,
    )
    return np.stack([np.asarray(d) for d in out["divs"]])


@pytest.mark.parametrize("method", ["reorder", "basic"])
def test_divergence_methods_agree(small_system, method):
    """Each autodiff method against the closed form and against the JAX
    package's same method (atol 2e-4, rtol 1e-3), batched over frames."""
    coords, _ = small_system
    subset = coords[:6]
    got = _divs(pt, subset, method, batch_size=4)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, _divs(pt, subset, "closed"), atol=2e-4, rtol=1e-3)
    np.testing.assert_allclose(got, _divs(jt, subset, method), atol=2e-4, rtol=1e-3)


@pytest.mark.parametrize("method", ["reorder", "basic"])
def test_autodiff_divergence_nan_on_own_cg_point(small_system, method):
    """A cg atom with no partner sits on its cg point: both autodiff methods
    give NaN there, in the port as in the JAX package; the closed form
    stays finite."""
    coords, _ = small_system
    unpartnered = {frozenset({1, 2})}
    got = _divs(pt, coords[:3], method, unpartnered)
    expect = _divs(jt, coords[:3], method, unpartnered)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(expect))
    assert np.isnan(got).any()
    assert np.isfinite(_divs(pt, coords[:3], "closed", unpartnered)).all()


def test_unknown_divergence_method_raises(small_system):
    coords, _ = small_system
    with pytest.raises(ValueError, match="Unknown method"):
        _divs(pt, coords[:3], "bogus")


def test_gb_subfeat_jac_shapes():
    """The reorder jacobian channelizes along the derivative-site axis."""
    from aggforce_torch.qp.feat import channel_allocate

    jac = torch.arange(2 * 3 * 4 * 3, dtype=torch.float32).reshape(2, 3, 4, 3)
    out = channel_allocate(jac, (0, 1, 1, 0), 1, jac_shape=True)
    assert out.shape == (4, 3, 4, 3)
    torch.testing.assert_close(out[:2, :, 0], jac[:, :, 0])
    assert torch.all(out[2:, :, 0] == 0)
