"""Port parity: torch core ops, trajectories and maps against the JAX package."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import aggforce_torch as pt
from aggforce_torch.map import CLAFTMap, SeperableTMap, TLinearMap
from aggforce_torch.ops import torchcore
from aggforce_torch.trajectory import Trajectory

import aggforce_tpu as jt
from aggforce_tpu.map import JLinearMap
from aggforce_tpu.map import SeperableTMap as JSeperableTMap
from aggforce_tpu.ops import jaxcore

RNG = np.random.default_rng(11)
XYZ = RNG.normal(size=(5, 7, 3)).astype(np.float32)
CROSS = RNG.normal(size=(5, 2, 3)).astype(np.float32)
FACTOR2 = RNG.normal(size=(4, 7)).astype(np.float32)
FACTOR3 = RNG.normal(size=(5, 4, 7)).astype(np.float32)


@pytest.mark.parametrize(
    "name, args, kwargs",
    [
        ("trjdot", (XYZ, FACTOR2), {}),
        ("trjdot", (XYZ, FACTOR3), {}),
        ("distances", (XYZ,), {}),
        ("distances", (XYZ,), {"cross_xyz": CROSS}),
        ("distances", (XYZ,), {"return_matrix": False}),
        ("distances", (XYZ,), {"return_displacements": True}),
        ("distances", (XYZ,), {"square": True}),
        ("qp_form", (XYZ,), {}),
    ],
)
def test_torchcore_matches_jaxcore(name, args, kwargs):
    expect = np.asarray(getattr(jaxcore, name)(
        *map(jnp.asarray, args),
        **{k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
           for k, v in kwargs.items()},
    ))
    got = getattr(torchcore, name)(
        *map(torch.as_tensor, args),
        **{k: torch.as_tensor(v) if isinstance(v, np.ndarray) else v
           for k, v in kwargs.items()},
    ).numpy()
    np.testing.assert_allclose(got, expect, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("chunk", [None, 2, 3, 10])
def test_abatch_matches_jaxcore(chunk):
    expect = np.asarray(jaxcore.abatch(lambda a: a * 2.0, jnp.asarray(XYZ), chunk))
    got = torchcore.abatch(lambda a: a * 2.0, torch.as_tensor(XYZ), chunk).numpy()
    np.testing.assert_array_equal(got, expect)


def _maps():
    groups = [[0, 1], [3], [4, 5, 6]]
    return (
        jt.LinearMap(groups, n_fg_sites=7),
        pt.LinearMap(groups, n_fg_sites=7),
        JLinearMap(groups, n_fg_sites=7),
        TLinearMap(groups, n_fg_sites=7, device="cpu"),
    )


def test_linear_maps_match():
    jl, pl, jj, tl = _maps()
    np.testing.assert_array_equal(pl(XYZ), jl(XYZ))
    expect = np.asarray(jj(XYZ))
    got_np = tl(XYZ)
    assert isinstance(got_np, np.ndarray)
    np.testing.assert_allclose(got_np, expect, rtol=1e-6, atol=1e-6)
    got_t = tl(torch.as_tensor(XYZ))
    assert isinstance(got_t, torch.Tensor)
    np.testing.assert_allclose(got_t.numpy(), expect, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        tl.flat_call(XYZ.reshape(5, -1)), np.asarray(jj.flat_call(XYZ.reshape(5, -1))),
        rtol=1e-6, atol=1e-6,
    )


@pytest.mark.parametrize(
    "site, value, raises",
    [(2, np.nan, False), (0, np.nan, True), (2, np.inf, False), (4, np.inf, False)],
)
def test_nan_verdict_matches(site, value, raises):
    """NaN on a zero-weight site is filled, on a weighted site it raises; inf
    is never filled and propagates exactly as in the JAX map."""
    _, _, jj, tl = _maps()
    x = XYZ.copy()
    x[1, site, 2] = value
    if raises:
        with pytest.raises(ValueError):
            jj(x)
        with pytest.raises(ValueError):
            tl(x)
        with pytest.raises(ValueError):
            tl(torch.as_tensor(x))
        return
    expect = np.asarray(jj(x))
    got = tl(x)
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(expect))
    fin = np.isfinite(expect)
    np.testing.assert_allclose(got[fin], expect[fin], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("nan_site, raises", [(2, False), (3, True)])
def test_separable_tmap_matches(nan_site, raises):
    _, _, jj, tl = _maps()
    forces = XYZ[::-1].copy()
    forces[0, nan_site, 0] = np.nan
    jmap = JSeperableTMap(coord_map=jj, force_map=jj)
    tmap = SeperableTMap(coord_map=tl, force_map=tl)
    if raises:
        with pytest.raises(ValueError):
            tmap.map_arrays(XYZ, forces)
        with pytest.raises(ValueError):
            jmap.map_arrays(XYZ, forces)
        return
    jc, jf = jmap.map_arrays(XYZ, forces)
    tc, tf = tmap.map_arrays(XYZ, torch.as_tensor(forces))
    assert isinstance(tc, np.ndarray) and isinstance(tf, torch.Tensor)
    np.testing.assert_allclose(tc, np.asarray(jc), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=1e-6, atol=1e-6)


def test_claft_map_with_linear_force_map():
    """CLAFTMap composes a coordinate map with a configuration-dependent
    force map; a CLAMap built from constant scale/trans reproduces JAX's."""
    jl, pl, jj, tl = _maps()
    mat = FACTOR2[:3]
    offset = RNG.normal(size=(1, 3, 3)).astype(np.float32)

    def scale(y):
        return np.broadcast_to(mat, (y.shape[0],) + mat.shape)

    def trans(y):
        return np.broadcast_to(offset, (y.shape[0], 3, 3))

    jmap = jt.map.CLAFTMap(
        coord_map=jj, force_map=jt.map.CLAMap(scale, trans, n_fg_sites=7)
    )
    tmap = CLAFTMap(coord_map=tl, force_map=pt.map.CLAMap(scale, trans, n_fg_sites=7))
    jc, jf = jmap.map_arrays(XYZ, XYZ * 2)
    tc, tf = tmap.map_arrays(XYZ, XYZ * 2)
    np.testing.assert_allclose(tc, np.asarray(jc), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tf, np.asarray(jf), rtol=1e-6, atol=1e-6)


def test_trajectory_keeps_tensors_on_their_device():
    coords = torch.as_tensor(XYZ)
    traj = Trajectory(coords=coords, forces=coords * 2)
    assert isinstance(traj[1:3].coords, torch.Tensor)
    copied = traj.copy()
    assert copied.coords is not traj.coords
    assert torch.equal(copied.forces, traj.forces)
    cast = traj.astype(np.float64)
    assert cast.coords.dtype == torch.float64
    assert cast.forces.device == coords.device
    np.testing.assert_array_equal(
        Trajectory(coords=XYZ, forces=XYZ).astype(np.float64).coords, XYZ
    )


def _shift_augmenter(base):
    """A deterministic augmenter (same arithmetic for numpy and tensors):
    two virtual sites at the first two real sites plus a fixed offset."""

    class Shift(base):
        def __init__(self):
            pass

        def sample(self, source):
            return source[:, :2] + 0.1

        def log_gradient(self, source, generated):
            return -0.5 * source, 2.0 * generated

        def astype(self, *args, **kwargs):
            return self

    return Shift()


@pytest.mark.parametrize("as_tensor", [False, True])
def test_augmented_and_composed_tmaps_match_jax(as_tensor):
    """AugmentedTMap -> RATMap/ComposedTMap/NullForcesTMap chains give the
    JAX package's arrays, and tensor inputs stay tensors."""
    from aggforce_torch.map import AugmentedTMap, ComposedTMap, NullForcesTMap, RATMap
    from aggforce_torch.trajectory import Augmenter

    from aggforce_tpu.map import AugmentedTMap as JAugmentedTMap
    from aggforce_tpu.map import ComposedTMap as JComposedTMap
    from aggforce_tpu.map import NullForcesTMap as JNullForcesTMap
    from aggforce_tpu.map import RATMap as JRATMap
    from aggforce_tpu.trajectory import Augmenter as JAugmenter

    _, _, jj, tl = _maps()
    jsep = JSeperableTMap(coord_map=jj, force_map=jj)
    tsep = SeperableTMap(coord_map=tl, force_map=tl)
    # null the forces, augment with two virtual sites, map the real block
    jmap = JComposedTMap([
        JAugmentedTMap(JRATMap(jsep), _shift_augmenter(JAugmenter), kbt=0.7),
        JNullForcesTMap(fill_value=0.0, warn_input_forces=False),
    ])
    tmap = ComposedTMap([
        AugmentedTMap(RATMap(tsep), _shift_augmenter(Augmenter), kbt=0.7),
        NullForcesTMap(fill_value=0.0, warn_input_forces=False),
    ])
    forces = XYZ[::-1].copy()
    jc, jf = jmap.map_arrays(XYZ, forces)
    assert np.asarray(jc).shape == (5, 5, 3)
    x = torch.as_tensor(XYZ) if as_tensor else XYZ
    f = torch.as_tensor(forces) if as_tensor else forces
    tc, tf = tmap.map_arrays(x, f)
    assert isinstance(tc, torch.Tensor) == as_tensor
    got_c = tc.numpy() if as_tensor else tc
    got_f = tf.numpy() if as_tensor else tf
    np.testing.assert_allclose(got_c, np.asarray(jc), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got_f, np.asarray(jf), rtol=1e-6, atol=1e-6)


_PDB = """\
ATOM      1  N   GLY A   1      -0.966   0.493   1.500  1.00  0.00           N
ATOM      2  H   GLY A   1      -1.800   0.100   1.200  1.00  0.00           H
ATOM      3  CA  GLY A   1       0.257   0.418   0.692  1.00  0.00           C
ATOM      4  HA  GLY A   1       0.300   1.300   0.100  1.00  0.00           H
ATOM      5  C   GLY A   1      -0.094   0.017  -0.716  1.00  0.00           C
ATOM      6  O   GLY A   1      -1.056  -0.682  -0.923  1.00  0.00           O
ATOM      7  CA  ALA A   2       1.500   1.000  -1.500  1.00  0.00
ENDMDL
ATOM      8  CA  ALA A   2       9.000   9.000   9.000  1.00  0.00           C
"""


def test_pdblite_copy_matches_jax(tmp_path):
    from aggforce_torch.utils import pdblite as ppdb
    from aggforce_torch.utils.synth import synthesize_protein_fixture

    from aggforce_tpu.utils import pdblite as jpdb
    from aggforce_tpu.utils.synth import synthesize_protein_fixture as jax_fixture

    path = tmp_path / "tiny.pdb"
    path.write_text(_PDB)
    path = str(path)
    assert ppdb.read_pdb_atoms(path)[-1].element == "C"  # from the atom name
    for fn in ("pdb_coordinates", "ca_map_from_pdb", "guess_h_bond_groups",
               "n_atoms", "element_masses"):
        np.testing.assert_array_equal(
            np.asarray(getattr(ppdb, fn)(path), dtype=object),
            np.asarray(getattr(jpdb, fn)(path), dtype=object),
        )
    assert ppdb.find_atom_indices(path, "^C") == jpdb.find_atom_indices(path, "^C")
    got, expect = synthesize_protein_fixture(path, 20, seed=3), jax_fixture(path, 20, seed=3)
    for key in ("coords", "forces"):
        np.testing.assert_array_equal(got[key], expect[key])
    assert got["constraint_groups"] == expect["constraint_groups"]


def test_reference_waterdimer_copy_matches_jax(tmp_path):
    from aggforce_torch.utils.synth import reference_waterdimer

    from aggforce_tpu.utils.synth import reference_waterdimer as jax_waterdimer

    assert reference_waterdimer(str(tmp_path / "absent.npz")) is None
    assert jax_waterdimer(str(tmp_path / "absent.npz")) is None
    rng = np.random.default_rng(4)
    path = str(tmp_path / "dimer.npz")
    np.savez(path, coords=rng.normal(size=(7, 6, 3)), Fs=rng.normal(size=(7, 6, 3)))
    got, expect = reference_waterdimer(path), jax_waterdimer(path)
    assert got.keys() == expect.keys() == {"coords", "forces"}
    for key in got:
        np.testing.assert_array_equal(got[key], expect[key])


def test_example_system(tmp_path):
    """The examples' standalone system is bench.py:290-307's (the fixture
    of chip_smoke.py's configs #1-#3 from the same seeds); with a PDB it is
    that PDB's CLN025-style fixture and C-alpha map; a missing PDB raises."""
    from aggforce_torch.utils.pdblite import ca_map_from_pdb
    from aggforce_torch.utils.synth import (
        example_system,
        synthesize_protein_fixture,
        synthesize_trajectory,
    )

    fix, cmap, label = example_system(12, seed=2024)
    assert label == "standalone (bench.py:290-307)"
    base = np.random.default_rng(0).normal(scale=0.5, size=(175, 3))
    groups = [frozenset((i, i + 1)) for i in range(0, 60, 2)]
    coords, forces = synthesize_trajectory(base, groups, 12, seed=2024)
    np.testing.assert_array_equal(fix["coords"], coords)
    np.testing.assert_array_equal(fix["forces"], forces)
    assert fix["constraint_groups"] == groups and float(fix["kbt"]) == 0.6955215
    np.testing.assert_array_equal(
        cmap.standard_matrix,
        pt.LinearMap([[i] for i in range(0, 175, 18)], n_fg_sites=175).standard_matrix,
    )

    path = tmp_path / "tiny.pdb"
    path.write_text(_PDB)
    fix, cmap, label = example_system(10, seed=3, pdb=str(path))
    expect = synthesize_protein_fixture(str(path), 10, seed=3)
    np.testing.assert_array_equal(fix["coords"], expect["coords"])
    assert label == f"pdb {path}" and cmap.n_cg_sites == len(ca_map_from_pdb(str(path)))
    with pytest.raises(FileNotFoundError, match="missing topology fixture"):
        example_system(10, seed=3, pdb=str(tmp_path / "absent.pdb"))


def test_device_synthesis_structure():
    """The device twin's random stream differs from numpy's, so it is held
    to the construction: rigid groups, zero-sum constraint forces (with
    the noise off, a group's forces sum to its tether force), the tether
    itself on loose sites, and determinism per seed."""
    from aggforce_torch.utils import synth

    rng = np.random.default_rng(0)
    n, kbt, scale = 30, 0.7, 0.02
    base = rng.normal(scale=0.5, size=(n, 3))
    groups = [frozenset((0, 1)), frozenset((4, 5, 6)), frozenset((10, 11))]
    old = synth.DEVICE_BLOCK
    synth.DEVICE_BLOCK = 64  # several blocks and a ragged last one
    try:
        coords, forces = synth.synthesize_trajectory_device(
            base, groups, 150, seed=2, motion_scale=scale, kbt=kbt,
            noise_force_scale=0.0, device="cpu",
        )
        again = synth.synthesize_trajectory_device(
            base, groups, 150, seed=2, motion_scale=scale, kbt=kbt,
            noise_force_scale=0.0, device="cpu",
        )
        other = synth.synthesize_trajectory_device(base, groups, 150, seed=3, device="cpu")
    finally:
        synth.DEVICE_BLOCK = old
    assert coords.shape == forces.shape == (150, n, 3)
    assert coords.dtype == forces.dtype == torch.float32
    torch.testing.assert_close(again[0], coords, rtol=0, atol=0)
    torch.testing.assert_close(again[1], forces, rtol=0, atol=0)
    assert not torch.equal(other[0], coords)
    c, f = coords.double().numpy(), forces.double().numpy()
    disp = c - base[None]
    k = kbt / scale**2
    for g in groups:
        g = sorted(g)
        # the group moves rigidly: every member shares one displacement
        np.testing.assert_allclose(disp[:, g], disp[:, g[:1]].repeat(len(g), 1), atol=1e-5)
        # the constraint forces cancel within the group
        np.testing.assert_allclose(f[:, g].sum(1), -k * disp[:, g[0]], rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(f[:, 20], -k * disp[:, 20], rtol=1e-4, atol=1e-3)
    assert disp.std() == pytest.approx(scale, rel=0.05)
