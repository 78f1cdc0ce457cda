"""Port parity: TMap serialization round trips in the port, and maps saved by
either package loaded by the other."""

import numpy as np
import pytest
import torch

import aggforce_torch as pt
from aggforce_torch.map import (
    AugmentedTMap,
    CLAFTMap,
    CLAMap,
    ComposedTMap,
    NullForcesTMap,
    RATMap,
    SeperableTMap,
    TLinearMap,
)
from aggforce_torch.qp.fusedfeat import FusedGBMap, GBFeatSpec, fused_gb_linear_map
from aggforce_torch.trajectory import SimpleCondNormal, TCondNormal
from aggforce_torch.utils.serialize import load_tmap, save_tmap

import jax.numpy as jnp

import aggforce_tpu as jt
from aggforce_tpu import map as jmap
from aggforce_tpu.qp import fusedfeat as jff
from aggforce_tpu.trajectory import JCondNormal
from aggforce_tpu.utils import serialize as jser

N_ATOMS = 12
SITES = [[0], [4], [8]]
GROUPS = {frozenset({1, 2}), frozenset({5, 6})}


@pytest.fixture()
def rng():
    return np.random.default_rng(0)


@pytest.fixture(scope="module")
def system():
    rng = np.random.default_rng(3)
    coords = rng.normal(scale=0.7, size=(96, N_ATOMS, 3)).astype(np.float32)
    forces = rng.normal(size=(96, N_ATOMS, 3)).astype(np.float32)
    return coords, forces


def roundtrip(tmp_path, tmap):
    path = str(tmp_path / "map.npz")
    save_tmap(path, tmap)
    return load_tmap(path, device="cpu")


def test_linear_roundtrip(tmp_path, rng):
    lm = pt.LinearMap(rng.normal(size=(2, 5)), handle_nans=False)
    lm2 = roundtrip(tmp_path, lm)
    assert type(lm2) is pt.LinearMap
    np.testing.assert_array_equal(lm2.standard_matrix, lm.standard_matrix)
    assert lm2.handle_nans is False


def test_tlinear_roundtrip(tmp_path, rng):
    tlm = TLinearMap(rng.normal(size=(2, 5)), bypass_nan_check=True, device="cpu")
    tlm2 = roundtrip(tmp_path, tlm)
    assert isinstance(tlm2, TLinearMap) and tlm2.bypass_nan_check
    assert tlm2.device == torch.device("cpu")
    np.testing.assert_array_equal(tlm2.standard_matrix, tlm.standard_matrix)


def test_seperable_roundtrip(tmp_path, rng):
    tmap = SeperableTMap(
        coord_map=pt.LinearMap(rng.normal(size=(2, 5))),
        force_map=pt.LinearMap(rng.normal(size=(2, 5))),
    )
    tmap2 = roundtrip(tmp_path, tmap)
    coords = rng.normal(size=(4, 5, 3))
    forces = rng.normal(size=(4, 5, 3))
    np.testing.assert_allclose(
        tmap2.map_arrays(coords, forces)[1], tmap.map_arrays(coords, forces)[1],
        atol=1e-12,
    )


def _gauss_tmap(seed=9):
    cmap = TLinearMap(
        np.array([[1.0, 0.0, 0.0], [0.0, 0.5, 0.5]]), bypass_nan_check=True, device="cpu"
    )
    augmenter = TCondNormal(cov=0.01, premap=cmap.flat_call, seed=seed, device="cpu")
    inner = SeperableTMap(
        coord_map=pt.LinearMap(np.eye(5), handle_nans=False),
        force_map=pt.LinearMap(np.eye(5), handle_nans=False),
    )
    return AugmentedTMap(aug_tmap=inner, augmenter=augmenter, kbt=0.7)


def test_gauss_map_roundtrip(tmp_path, rng):
    """AugmentedTMap with a TCondNormal (linear premap) round trips and
    carries on the same noise stream: the generator state is saved, also
    after the map has drawn."""
    tmap = _gauss_tmap()
    coords = rng.normal(size=(6, 3, 3)).astype(np.float32)
    forces = rng.normal(size=(6, 3, 3)).astype(np.float32)
    tmap.map_arrays(coords, forces)  # advance the stream before saving
    tmap2 = roundtrip(tmp_path, tmap)
    assert tmap2.augmenter.seed == 9
    a = tmap.map_arrays(coords, forces)
    b = tmap2.map_arrays(coords, forces)
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])


def test_composed_nullforces_ratmap_roundtrip(tmp_path):
    tmap = ComposedTMap(
        [
            RATMap(
                SeperableTMap(
                    pt.LinearMap(np.eye(3), handle_nans=False),
                    pt.LinearMap(np.eye(3), handle_nans=False),
                )
            ),
            NullForcesTMap(warn_input_forces=False, fill_value=0.0),
        ]
    )
    tmap2 = roundtrip(tmp_path, tmap)
    assert isinstance(tmap2[1], NullForcesTMap)
    assert tmap2[1].fill_value == 0.0 and tmap2[1].warn_input_forces is False
    assert isinstance(tmap2[0], RATMap)
    assert np.isnan(roundtrip(tmp_path, NullForcesTMap()).fill_value)


def test_simple_augmenter_roundtrip(tmp_path):
    tmap = AugmentedTMap(
        aug_tmap=SeperableTMap(
            pt.LinearMap(np.eye(4), handle_nans=False),
            pt.LinearMap(np.eye(4), handle_nans=False),
        ),
        augmenter=SimpleCondNormal(var=0.2, dtype=np.float64),
        kbt=1.1,
    )
    tmap2 = roundtrip(tmp_path, tmap)
    assert isinstance(tmap2.augmenter, SimpleCondNormal)
    assert tmap2.augmenter.var == 0.2 and tmap2.augmenter.dtype == np.float64
    assert tmap2.kbt == 1.1


def test_closure_map_rejected(tmp_path):
    clam = CLAMap(
        scale=lambda c: np.ones((c.shape[0], 1, 2)),
        trans=lambda c: np.zeros((c.shape[0], 1, 3)),
        n_fg_sites=2,
    )
    with pytest.raises(ValueError, match="closures"):
        save_tmap(str(tmp_path / "x.npz"), CLAFTMap(pt.LinearMap(np.eye(2)), clam))
    with pytest.raises(ValueError, match="arbitrary callables"):
        save_tmap(
            str(tmp_path / "y.npz"),
            AugmentedTMap(
                aug_tmap=SeperableTMap(pt.LinearMap(np.eye(2)), pt.LinearMap(np.eye(2))),
                augmenter=TCondNormal(cov=0.1, premap=lambda x: x, device="cpu"),
                kbt=1.0,
            ),
        )


def _port_fused(coords, forces, **kw):
    return fused_gb_linear_map(
        pt.Trajectory(coords=coords, forces=forces), pt.LinearMap(SITES, n_fg_sites=N_ATOMS),
        kbt=0.7, spec=GBFeatSpec(outer=2.0, n_basis=3), constraints=GROUPS,
        l2_regularization=1e3, constraint_rng=np.random.default_rng(0), device="cpu",
        **kw,
    )


def test_fused_map_roundtrip_and_tags(tmp_path, system):
    """A FusedGBMap round trips with its scalar tags; coef_list is rebuilt;
    a batch fit's lazily fetched tags serialize too."""
    from aggforce_torch.qp.fusedfeat import _LazyCoefTags, fused_gb_linear_map_batch

    coords, forces = system
    tmap = _port_fused(coords, forces)
    tmap2 = roundtrip(tmp_path, tmap)
    assert isinstance(tmap2.force_map, FusedGBMap)
    _, f0 = tmap.map_arrays(coords[:10], forces[:10])
    _, f1 = tmap2.map_arrays(coords[:10], forces[:10])
    np.testing.assert_array_equal(f1, f0)
    assert tmap2.force_map.tags["solver_resid"] == pytest.approx(
        tmap.force_map.tags["solver_resid"]
    )
    batch = fused_gb_linear_map_batch(
        pt.Trajectory(coords=coords, forces=forces), pt.LinearMap(SITES, n_fg_sites=N_ATOMS),
        kbt=0.5, spec=GBFeatSpec(outer=1.0, n_basis=3), seeds=[0], constraints=set(),
        l2_regularization=1e3, resid_tol=0.5, device="cpu",
    )[0]
    assert isinstance(batch.force_map.tags, _LazyCoefTags)
    batch2 = roundtrip(tmp_path, batch)
    np.testing.assert_array_equal(
        np.stack(batch.force_map.tags["coef_list"]),
        np.stack(batch2.force_map.tags["coef_list"]),
    )


def test_staged_gauss_map_roundtrip(tmp_path, system):
    """A staged Gaussian map from the one-sync path round trips, and its
    seeded application carries on identically."""
    coords, forces = system
    traj = pt.Trajectory(coords=torch.as_tensor(coords), forces=torch.as_tensor(forces))
    tmap = pt.stagedjoptgauss_map(
        traj=traj, coord_map=pt.LinearMap(SITES, n_fg_sites=N_ATOMS), var=0.01,
        kbt=0.7, constraints=GROUPS, seed=21, device="cpu",
    )
    tmap2 = roundtrip(tmp_path, tmap)
    a = tmap.map_arrays(coords[:8], forces[:8])
    b = tmap2.map_arrays(coords[:8], forces[:8])
    np.testing.assert_allclose(np.asarray(a[0]), np.asarray(b[0]), atol=1e-6)
    np.testing.assert_allclose(np.asarray(a[1]), np.asarray(b[1]), atol=1e-4)


# --- across packages ---------------------------------------------------------


def _close(got, expect, rel=1e-6):
    expect = np.asarray(expect)
    np.testing.assert_allclose(np.asarray(got), expect, atol=rel * np.abs(expect).max())


def test_jax_saved_separable_map_loads_in_port(tmp_path, system):
    coords, forces = system
    # device arrays in: the JAX fit returns JLinearMaps
    jmap_ = jt.qp_linear_map(
        jt.Trajectory(coords=jnp.asarray(coords), forces=jnp.asarray(forces)),
        jt.LinearMap(SITES, n_fg_sites=N_ATOMS), constraints=GROUPS,
    )
    assert isinstance(jmap_.force_map, jmap.JLinearMap)
    path = str(tmp_path / "jax_linear.npz")
    jser.save_tmap(path, jmap_)
    port = load_tmap(path, device="cpu")
    assert isinstance(port.force_map, TLinearMap)
    jc, jf = jmap_.map_arrays(coords, forces)
    pc, pf = port.map_arrays(coords, forces)
    _close(pc, jc)
    _close(pf, jf)


def test_jax_saved_fused_map_loads_in_port(tmp_path, system):
    coords, forces = system
    jfit = jff.fused_gb_linear_map(
        jt.Trajectory(coords=coords, forces=forces), jt.LinearMap(SITES, n_fg_sites=N_ATOMS),
        kbt=0.7, spec=jff.GBFeatSpec(outer=2.0, n_basis=3), constraints=GROUPS,
        l2_regularization=1e3, constraint_rng=np.random.default_rng(0),
    )
    path = str(tmp_path / "jax_fused.npz")
    jser.save_tmap(path, jfit)
    port = load_tmap(path, device="cpu")
    assert isinstance(port.force_map, FusedGBMap)
    assert port.force_map.tags["solver_resid"] == pytest.approx(
        jfit.force_map.tags["solver_resid"]
    )
    jc, jf = jfit.map_arrays(coords, forces)
    pc, pf = port.map_arrays(coords, forces)
    _close(pc, jc)
    _close(pf, jf)


@pytest.mark.parametrize("kind", ["separable", "fused"])
def test_port_saved_map_loads_in_jax(tmp_path, system, kind):
    coords, forces = system
    if kind == "fused":
        tmap = _port_fused(coords, forces)
    else:
        tmap = pt.qp_linear_map(
            pt.Trajectory(coords=torch.as_tensor(coords), forces=torch.as_tensor(forces)),
            pt.LinearMap(SITES, n_fg_sites=N_ATOMS), constraints=GROUPS, device="cpu",
        )
        assert isinstance(tmap.force_map, TLinearMap)
    path = str(tmp_path / f"port_{kind}.npz")
    save_tmap(path, tmap)
    jax = jser.load_tmap(path)
    if kind == "fused":
        assert isinstance(jax.force_map, jff.FusedGBMap)
    else:
        assert isinstance(jax.force_map, jmap.JLinearMap)
    pc, pf = tmap.map_arrays(coords, forces)
    jc, jf = jax.map_arrays(coords, forces)
    _close(jc, pc)
    _close(jf, pf)


def _augmenter_parts(aug):
    """(premap matrix, postmap matrix or None, scalar variance, dtype)."""
    def matrix(field):
        owner = getattr(field, "__self__", field)
        return None if not hasattr(owner, "standard_matrix") else np.asarray(owner.standard_matrix)

    return matrix(aug.premap), matrix(aug.source_postmap), float(aug._cov), np.dtype(aug.dtype)


def test_augmented_maps_cross_packages(tmp_path, rng):
    """Augmented maps in both directions: the inner maps, the premap and
    postmap matrices and the variance carry over (the draws do not: a JAX
    key and a torch generator make different noise)."""
    port_map = _gauss_tmap()
    port_map.augmenter.source_postmap = TLinearMap(np.eye(3), device="cpu")
    path = str(tmp_path / "port_aug.npz")
    save_tmap(path, port_map)
    jax = jser.load_tmap(path)
    assert isinstance(jax.augmenter, JCondNormal)

    jaug = JCondNormal(
        cov=0.01, seed=9,
        premap=jmap.JLinearMap(
            np.array([[1.0, 0.0, 0.0], [0.0, 0.5, 0.5]]), bypass_nan_check=True
        ).flat_call,
    )
    jax_map = jmap.AugmentedTMap(
        aug_tmap=jmap.SeperableTMap(
            jt.LinearMap(np.eye(5), handle_nans=False), jt.LinearMap(np.eye(5), handle_nans=False)
        ),
        augmenter=jaug, kbt=0.7,
    )
    path = str(tmp_path / "jax_aug.npz")
    jser.save_tmap(path, jax_map)
    port = load_tmap(path, device="cpu")
    assert isinstance(port.augmenter, TCondNormal)

    for src, dst in ((port_map, jax), (jax_map, port)):
        a, b = _augmenter_parts(src.augmenter), _augmenter_parts(dst.augmenter)
        np.testing.assert_array_equal(a[0], b[0])
        assert (a[1] is None) == (b[1] is None)
        if a[1] is not None:
            np.testing.assert_array_equal(a[1], b[1])
        assert a[2:] == b[2:]
        assert dst.kbt == src.kbt
        np.testing.assert_array_equal(
            dst.tmap.force_map.standard_matrix, src.tmap.force_map.standard_matrix
        )
    coords = rng.normal(size=(6, 3, 3)).astype(np.float32)
    forces = rng.normal(size=(6, 3, 3)).astype(np.float32)
    for tmap in (jax, port):  # both apply; their noise differs by design
        mc, mf = tmap.map_arrays(coords, forces)
        assert np.asarray(mc).shape == (6, 5, 3) and np.isfinite(np.asarray(mf)).all()


def test_seed_survives_the_key_words(tmp_path):
    """The port writes its seed as a JAX key's two words and reads them back."""
    for seed in (0, 9, 2**32 + 5, 2**63 + 11):
        tmap = _gauss_tmap(seed)
        assert roundtrip(tmp_path, tmap).augmenter.seed == seed
