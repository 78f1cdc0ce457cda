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


# ---------------------------------------------------------------------------
# The apply: the card's kernel (ops.gb_apply) and the CPU's plain path

# two pairs and a three-atom group, so groups of 1, 2 and 3 atoms
APPLY_GROUPS = {frozenset((0, 1)), frozenset((4, 5)), frozenset((10, 11)), frozenset((11, 12))}


def _apply_operands(system, include_id, dtype, n_frames=40, n_basis=4):
    """(points, copoints, coefs, consts, spec) of a FusedGBMap with seeded
    coefficients over APPLY_GROUPS, as ``dtype`` tensors on the CPU; consts
    are ``map_constants``' (cmap, onehot, counts, group_mean, centers)."""
    coords, forces = system
    cmap = pt.LinearMap(SITES, n_fg_sites=N_ATOMS)
    spec = pff.GBFeatSpec(outer=2.0, n_basis=n_basis, include_id=include_id)
    geom = pff.group_factorization(cmap, spec, APPLY_GROUPS)
    g = geom["onehot"].shape[1]
    coefs = np.random.default_rng(5).normal(size=(len(SITES), g * (n_basis + include_id)))
    consts = pff.map_constants(
        cmap.standard_matrix, geom["onehot"], geom["centers"], torch.device("cpu")
    )

    def cast(x):
        return torch.as_tensor(np.asarray(x), dtype=dtype).contiguous()

    cmap_t, onehot, counts, _, centers = (c.to(dtype) for c in consts)
    # the group means' 1/count weights in ``dtype`` (1/3 is not a float32)
    group_mean = (onehot / counts).T.contiguous()
    return (
        cast(forces[:n_frames]), cast(coords[:n_frames]), cast(coefs),
        (cmap_t, onehot, counts, group_mean, centers), spec, geom,
    )


@pytest.mark.parametrize("include_id", [True, False])
def test_cpu_apply_is_the_plain_path_bit_for_bit(system, include_id):
    """A map on the CPU applies through ``_fused_apply``, chunk by chunk,
    for tensors and numpy alike, and never reaches the kernel."""
    from aggforce_torch.ops.gb_apply import gb_apply

    points, copoints, coefs, consts, spec, geom = _apply_operands(
        system, include_id, torch.float32
    )
    fmap = pff.FusedGBMap(
        coefs, _sites_matrix(), geom["onehot"], geom["centers"], KBT, spec,
        device="cpu",
    )
    cmap, onehot, counts, group_mean, centers = consts
    before = gb_apply.launches
    expect = pff._fused_apply(
        points, copoints, coefs, cmap, group_mean, onehot, counts, centers, KBT, spec
    )
    got = fmap(points, copoints)
    assert isinstance(got, torch.Tensor)
    assert torch.equal(got, expect)
    got_np = fmap(points.numpy(), copoints.numpy())
    np.testing.assert_array_equal(got_np, expect.numpy())
    assert gb_apply.launches == before
    assert fmap._kernel_consts is None


def _sites_matrix():
    return pt.LinearMap(SITES, n_fg_sites=N_ATOMS).standard_matrix.astype(np.float32)


def test_cpu_apply_chunks_long_inputs(system, monkeypatch):
    """On the CPU a call longer than ``_APPLY_CHUNK`` frames applies chunk by
    chunk, each chunk the plain path's bits on its frames."""
    points, copoints, coefs, consts, spec, geom = _apply_operands(system, True, torch.float32)
    fmap = pff.FusedGBMap(
        coefs, _sites_matrix(), geom["onehot"], geom["centers"], KBT, spec, device="cpu"
    )
    calls = []
    original = pff._fused_apply

    def counted(p, *rest):
        calls.append(p.shape[0])
        return original(p, *rest)

    monkeypatch.setattr(pff.FusedGBMap, "_APPLY_CHUNK", 16)
    monkeypatch.setattr(pff, "_fused_apply", counted)
    got = fmap(points, copoints)
    assert calls == [16, 16, 8]
    monkeypatch.setattr(pff.FusedGBMap, "_APPLY_CHUNK", 4096)
    assert torch.equal(got, fmap(points, copoints))


@pytest.mark.parametrize("include_id", [True, False])
def test_group_sums_equal_the_atom_sums(system, include_id):
    """The kernel's formula (``gb_apply_witness``: the group weights times
    the groups' summed forces, count * sum_k dphi_k c_k * u for the
    divergence) equals the plain path's atom sums (the (t, S, N) one-hot
    spread and the (t, S, G, K, 3) divergence block), in float64 on the CPU."""
    from aggforce_torch.ops.gb_apply import gb_apply_witness

    points, copoints, coefs, consts, spec, _ = _apply_operands(
        system, include_id, torch.float64
    )
    cmap, onehot, counts, group_mean, centers = consts
    plain = pff._fused_apply(
        points, copoints, coefs, cmap, group_mean, onehot, counts, centers, KBT, spec
    )
    grouped, _, _ = gb_apply_witness(
        points, copoints, coefs, cmap, onehot, counts, centers, KBT, spec, frame_chunk=16
    )
    assert plain.dtype == grouped.dtype == torch.float64
    scale = float(plain.abs().max())
    np.testing.assert_allclose(grouped.numpy(), plain.numpy(), rtol=0, atol=1e-12 * scale)
    # the identity is not vacuous: without the divergence term it fails
    no_div, _, _ = gb_apply_witness(
        points, copoints, coefs, cmap, onehot, counts, centers, 0.0, spec
    )
    assert float((no_div - plain).abs().max()) > 1e-6 * scale


@pytest.mark.parametrize("include_id", [True, False])
def test_witness_bound_holds_for_the_plain_fp32_path(system, include_id):
    """The witness's rounding bound for fp32 geometry, widened by the plain
    path's own fp32 sums (n u ``scale`` for its N-atom and G (K + 1)-column
    contractions), holds the plain float32 path on the CPU; it and the
    kernel's bound (fp64 geometry, tighter) are far below the terms'
    magnitudes (they bound rounding, not the answer's size)."""
    from aggforce_torch.ops.gb_apply import gb_apply_witness

    points, copoints, coefs, consts, spec, _ = _apply_operands(
        system, include_id, torch.float32
    )
    cmap, onehot, counts, group_mean, centers = consts
    plain = pff._fused_apply(
        points, copoints, coefs, cmap, group_mean, onehot, counts, centers, KBT, spec
    )
    value, bound, scale = gb_apply_witness(
        points, copoints, coefs, cmap, onehot, counts, centers, KBT, spec,
        fp32_geometry=True,
    )
    _, kernel_bound, _ = gb_apply_witness(
        points, copoints, coefs, cmap, onehot, counts, centers, KBT, spec
    )
    n_terms = N_ATOMS + onehot.shape[1] * (spec.n_basis + 1)
    limit = bound + 2.0 * n_terms * 2.0**-24 * scale
    gap = (plain.double() - value).abs()
    assert bool((gap <= limit).all()), float((gap / limit).max())
    assert float((bound / scale).max()) < 1e-4
    assert bool((kernel_bound < bound).all())


def test_group_members_lists_each_group_in_atom_order(system):
    from aggforce_torch.ops.gb_apply import group_members

    geom = pff.group_factorization(
        pt.LinearMap(SITES, n_fg_sites=N_ATOMS), pff.GBFeatSpec(outer=2.0), APPLY_GROUPS
    )
    offsets, atoms = group_members(geom["onehot"])
    assert offsets.dtype == atoms.dtype == np.int32
    assert offsets[0] == 0 and offsets[-1] == N_ATOMS == len(atoms)
    np.testing.assert_array_equal(np.diff(offsets), geom["counts"])
    groups = [tuple(atoms[offsets[g] : offsets[g + 1]]) for g in range(len(offsets) - 1)]
    assert sorted(groups) == sorted(
        {tuple(sorted(m)) for m in ({0, 1}, {4, 5}, {10, 11, 12})}
        | {(j,) for j in range(N_ATOMS) if j not in {0, 1, 4, 5, 10, 11, 12}}
    )
    for g, members in enumerate(groups):
        assert list(members) == sorted(members)
        assert all(geom["onehot"][j, g] == 1 for j in members)
    bad = geom["onehot"].copy()
    bad[3] = 0.0  # atom 3 in no group
    with pytest.raises(ValueError, match="exactly one group"):
        group_members(bad)
    bad[3, 0] = 0.5
    with pytest.raises(ValueError, match="0s and 1s"):
        group_members(bad)


@pytest.mark.parametrize("dist_power", [1.0, 0.5])
def test_exact_centers_are_the_specs_float64_centers(dist_power):
    """The kernel's centers: the spec's float64 centers where the map holds
    their float32 rounding (as every fit and loader stores them), so its
    clip rule is decided on the float64 offsets; a map's own other centers
    as given."""
    spec = pff.GBFeatSpec(outer=8.0, n_basis=7, dist_power=dist_power)
    exact = pff._basis_centers(spec)
    stored = pff.group_factorization(
        pt.LinearMap(SITES, n_fg_sites=N_ATOMS), spec, APPLY_GROUPS
    )["centers"]
    assert stored.dtype == np.float32
    got = pff.exact_centers(stored, spec)
    assert got.dtype == np.float64
    np.testing.assert_array_equal(got, exact)
    if dist_power == 0.5:  # 5.56 A is not a float32: the two differ
        assert not np.array_equal(stored.astype(np.float64), exact)
    other = stored + np.float32(0.25)
    np.testing.assert_array_equal(pff.exact_centers(other, spec), other.astype(np.float64))
    np.testing.assert_array_equal(
        pff.exact_centers(stored[:-1], spec), stored[:-1].astype(np.float64)
    )


def _kernel_args(system, include_id=True):
    """gb_apply's arguments on the CPU (float32, the group lists int32, the
    centers float64): valid in all but the device."""
    from aggforce_torch.ops.gb_apply import group_members

    points, copoints, coefs, consts, spec, geom = _apply_operands(
        system, include_id, torch.float32
    )
    cmap, _, counts, _, _ = consts
    offsets, atoms = (torch.as_tensor(x) for x in group_members(geom["onehot"]))
    centers = torch.as_tensor(pff.exact_centers(geom["centers"], spec))
    return dict(
        points=points, copoints=copoints, coefs=coefs, cmap_mat=cmap,
        offsets=offsets, atoms=atoms, counts=counts, centers=centers, kbt=KBT,
        spec=spec,
    )


@pytest.mark.parametrize(
    "case, match",
    [
        ("cpu", "CUDA card"),
        ("float64", "must be torch.float32"),
        ("int64_members", "must be torch.int32"),
        ("float32_centers", "must be torch.float64"),
        ("strided", "contiguous"),
        ("frames", "copoints"),
        ("coef_width", "coefs must be"),
        ("coef_width_without_id", "coefs must be"),
        ("numpy", "torch.Tensor"),
        ("centers", "centers must be"),
        ("offsets", "disagree"),
    ],
)
def test_gb_apply_refuses_before_any_launch(system, monkeypatch, case, match):
    """Every operand outside the kernel's contract raises before the library
    is loaded or a launch counted: the device, dtypes, contiguity, frame
    counts, and a coefficient width that is not G (n_basis + include_id)."""
    from aggforce_torch.ops import gb_apply as mod

    args = _kernel_args(system, include_id=case != "coef_width_without_id")

    def no_library():
        raise AssertionError("the library was reached")

    monkeypatch.setattr(mod, "_lib", no_library)
    if case == "float64":
        args["points"] = args["points"].double()
    elif case == "int64_members":
        args["atoms"] = args["atoms"].long()
    elif case == "float32_centers":
        args["centers"] = args["centers"].float()
    elif case == "strided":
        args["copoints"] = args["copoints"].transpose(0, 1).contiguous().transpose(0, 1)
    elif case == "frames":
        args["copoints"] = args["copoints"][:-1].contiguous()
    elif case == "coef_width":
        args["coefs"] = args["coefs"][:, :-1].contiguous()
    elif case == "coef_width_without_id":
        # coefficients with the id block, given to a map without one
        args["spec"] = dataclasses.replace(args["spec"], include_id=False)
        g = args["counts"].shape[0]
        args["coefs"] = torch.zeros((len(SITES), g * (args["spec"].n_basis + 1)))
    elif case == "numpy":
        args["points"] = args["points"].numpy()
    elif case == "centers":
        args["centers"] = args["centers"][:-1].contiguous()
    elif case == "offsets":
        args["offsets"] = args["offsets"][:-1].contiguous()
    before = mod.gb_apply.launches
    with pytest.raises((ValueError, TypeError), match=match):
        mod.gb_apply(**args)
    assert mod.gb_apply.launches == before


def test_apply_kernel_source_has_no_fast_math_or_atomics():
    """``csrc/gb_apply.cu`` keeps IEEE arithmetic (the fp32 ``expf``, fp64
    square roots and divisions rounded to nearest) and a fixed order of
    sums: no fast-math intrinsics, no atomics, no fast-math build flag."""
    import re

    from aggforce_torch.ops import _build

    text = (_build.CSRC / "gb_apply.cu").read_text()
    code = re.sub(r"//[^\n]*", "", text)
    for banned in ("__expf", "__logf", "__powf", "__fdividef", "__frcp_r", "__fsqrt_r[duz]",
                   "__sinf", "__cosf", "atomic", "rsqrtf"):
        assert not re.search(banned, code), banned
    assert "expf(" in code and "__dsqrt_rn(" in code and "__ddiv_rn(" in code
    assert not any("fast" in flag for flag in _build.NVCC_FLAGS)
