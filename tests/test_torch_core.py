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
