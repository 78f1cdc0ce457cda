"""Port parity: the Gaussian augmenters against the JAX package's.

Where the noise is an input (the closed-form log-gradients, and the
augmentation fed JAX's own draw) the port must give JAX's numbers; where the
port draws (a torch generator cannot replay a JAX key) it is held to the
distribution, to its own generator's state, and to itself across its fused
and piecewise paths.
"""

import jax.numpy as jnp
import jax.random as jrandom
import numpy as np
import pytest
import torch

from aggforce_torch.map import TLinearMap
from aggforce_torch.trajectory import AugmentedTrajectory, SimpleCondNormal, TCondNormal
from aggforce_torch.trajectory import gaussian as pgauss
from aggforce_torch.utils.synth import synthesize_trajectory

from aggforce_tpu.map import JLinearMap
from aggforce_tpu.trajectory import JCondNormal
from aggforce_tpu.trajectory import SimpleCondNormal as JSimpleCondNormal

VAR = 0.002
KBT = 0.6955215
N_ATOMS = 40
GROUPS = [frozenset((i, i + 1)) for i in range(0, 12, 2)]
SITES = list(range(0, N_ATOMS, 10))
# log-gradients of the same (source, generated): tests/test_gaussian_augmenters.py:26
LGRAD_ATOL = 2e-6
# the augmentation fed JAX's draw: its coordinates to 1e-6 absolute; its
# forces, and any mapped output, to 1e-6 of the largest entry. The forces
# reach ~200 here, where one float32 step is 1.5e-5, and XLA contracts
# f + kbt*g into one fused multiply-add where torch rounds kbt*g first;
# mapped outputs are sums of 44 products taken in another order
AUG_TOL = 1e-6


def _close_scaled(got, ref):
    ref = np.asarray(ref)
    np.testing.assert_allclose(got, ref, atol=AUG_TOL * np.abs(ref).max(), rtol=0)


@pytest.fixture(scope="module")
def system():
    """40 atoms, 6 rigid pairs, 4 cg sites (one atom each), 300 frames."""
    base = np.random.default_rng(0).normal(scale=0.5, size=(N_ATOMS, 3))
    coords, forces = synthesize_trajectory(base, GROUPS, 300, seed=3)
    cmat = np.zeros((len(SITES), N_ATOMS))
    cmat[np.arange(len(SITES)), SITES] = 1.0
    return coords, forces, cmat


def _jax_eps(seed, n_frames, width):
    """The draw of a fresh JCondNormal(seed)'s first augmentation."""
    rkey, _ = jrandom.split(jrandom.PRNGKey(seed))
    _, sub = jrandom.split(rkey)
    return np.asarray(jrandom.normal(sub, (n_frames, width)))


@pytest.fixture()
def jax_draw(monkeypatch):
    """Make every port draw return the given array (JAX's draw)."""
    fed = {}

    def draw(gen, shape, device, dtype):  # noqa: ARG001
        assert tuple(shape) == fed["eps"].shape
        return torch.tensor(fed["eps"], device=device, dtype=dtype)

    monkeypatch.setattr(pgauss, "_standard_normal", draw)
    return fed


def test_simple_cond_normal_equals_jax():
    source = np.random.default_rng(1).normal(size=(50, 4, 3)).astype(np.float32)
    port, ref = SimpleCondNormal(var=0.07, seed=4), JSimpleCondNormal(var=0.07, seed=4)
    for _ in range(2):
        generated = port.sample(source)
        np.testing.assert_array_equal(generated, ref.sample(source))
        for a, b in zip(port.log_gradient(source, generated), ref.log_gradient(source, generated)):
            np.testing.assert_array_equal(a, b)
    assert port.astype(np.float64).sample(source).dtype == np.float64


MAT = np.array([[1.0, 0.0, 0.0], [0.0, 0.5, 0.5]])
POST = np.array([[2.0, 0.0, 0.0], [0.0, 1.0, 1.0], [0.5, 0.0, 1.0]])


def _cov(d):
    x = np.random.default_rng(2).normal(size=(d, d))
    return (x @ x.T / d + 0.5 * np.eye(d)).astype(np.float32)


CASES = {
    # name: (kwargs for (JAX, port) augmenters, source with a NaN?)
    "identity premap": (lambda dev: ({"cov": 0.07}, {"cov": 0.07}), False),
    "linear premap, NaN fill": (
        lambda dev: (
            {"cov": 0.3, "premap": JLinearMap(MAT, bypass_nan_check=True).flat_call},
            {"cov": 0.3, "premap": TLinearMap(MAT, bypass_nan_check=True, device=dev).flat_call},
        ),
        True,
    ),
    "full covariance, linear premap": (
        lambda dev: (
            {"cov": _cov(6), "premap": JLinearMap(MAT, bypass_nan_check=True).flat_call},
            {"cov": _cov(6), "premap": TLinearMap(MAT, bypass_nan_check=True, device=dev).flat_call},
        ),
        False,
    ),
    "source_postmap": (
        lambda dev: (
            {"cov": 0.2, "source_postmap": JLinearMap(POST, bypass_nan_check=True)},
            {"cov": 0.2, "source_postmap": TLinearMap(POST, bypass_nan_check=True, device=dev)},
        ),
        False,
    ),
    "callable premap (VJP)": (
        lambda dev: ({"cov": 0.1, "premap": jnp.sin}, {"cov": 0.1, "premap": torch.sin}),
        False,
    ),
    "callable premap, full covariance (VJP)": (
        lambda dev: ({"cov": _cov(9), "premap": jnp.sin}, {"cov": _cov(9), "premap": torch.sin}),
        False,
    ),
}


@pytest.mark.parametrize("case", sorted(CASES), ids=lambda c: c.replace(" ", "-"))
def test_log_gradients_equal_jax(case):
    """TCondNormal's (grad_x, grad_y) log g of the same (source, generated)
    equal JCondNormal's, with numpy in and numpy out."""
    make, with_nan = CASES[case]
    jkw, pkw = make("cpu")
    rng = np.random.default_rng(8)
    source = rng.normal(size=(12, 3, 3)).astype(np.float32)
    if with_nan:
        source[2, 0, 1] = np.nan  # an atom the premap reads
    jaug, paug = JCondNormal(seed=0, **jkw), TCondNormal(seed=0, device="cpu", **pkw)
    n_gen = paug.sample(source).shape[1]  # sets the deferred covariance
    jaug.sample(source)
    generated = rng.normal(size=(12, n_gen, 3)).astype(np.float32)
    got = paug.log_gradient(source, generated)
    ref = jaug.log_gradient(source, generated)
    for g, r in zip(got, ref):
        assert isinstance(g, np.ndarray) and g.dtype == np.float32
        np.testing.assert_allclose(g, np.asarray(r), atol=LGRAD_ATOL, rtol=0)


def test_log_gradient_requires_cov():
    with pytest.raises(ValueError, match="without cov"):
        TCondNormal(cov=0.1, device="cpu").log_gradient(np.zeros((2, 3, 3)), np.zeros((2, 3, 3)))


@pytest.mark.parametrize("postmap", [False, True], ids=["premap", "postmap"])
def test_fused_augment_with_jax_draw(system, jax_draw, postmap):
    """fused_augment fed JAX's draw gives JAX's extended arrays: the
    ``joptgauss_map`` augmenter (linear premap) and a staged post
    augmenter (identity premap, linear source_postmap)."""
    coords, forces, cmat = system
    seed = 7
    if postmap:
        post = np.random.default_rng(3).normal(size=(N_ATOMS, N_ATOMS)) * 0.1
        jaug = JCondNormal(cov=VAR, source_postmap=JLinearMap(post, bypass_nan_check=True), seed=seed)
        paug = TCondNormal(
            cov=VAR, source_postmap=TLinearMap(post, bypass_nan_check=True, device="cpu"),
            seed=seed, device="cpu",
        )
        width = N_ATOMS * 3
    else:
        jaug = JCondNormal(cov=VAR, premap=JLinearMap(cmat, bypass_nan_check=True).flat_call, seed=seed)
        paug = TCondNormal(
            cov=VAR, premap=TLinearMap(cmat, bypass_nan_check=True, device="cpu").flat_call,
            seed=seed, device="cpu",
        )
        width = len(SITES) * 3
    jax_draw["eps"] = _jax_eps(seed, len(coords), width)
    jc, jf = jaug.fused_augment(jnp.asarray(coords), jnp.asarray(forces), KBT)
    pc, pf = paug.fused_augment(torch.as_tensor(coords), torch.as_tensor(forces), KBT)
    assert isinstance(pc, torch.Tensor) and pc.shape == jc.shape
    np.testing.assert_allclose(pc.numpy(), np.asarray(jc), atol=AUG_TOL, rtol=0)
    _close_scaled(pf.numpy(), jf)


def test_fused_map_apply_with_jax_draw(system, jax_draw):
    """The whole AugmentedTMap application fed JAX's draw gives JAX's mapped
    coordinates and forces; a NaN on a participating atom raises in both."""
    coords, forces, cmat = system
    seed = 11
    rng = np.random.default_rng(5)
    n_ext = N_ATOMS + len(SITES)
    cmap_ext = rng.normal(size=(3, n_ext))
    fmap_ext = rng.normal(size=(3, n_ext))
    jaug = JCondNormal(cov=VAR, premap=JLinearMap(cmat, bypass_nan_check=True).flat_call, seed=seed)
    paug = TCondNormal(
        cov=VAR, premap=TLinearMap(cmat, bypass_nan_check=True, device="cpu").flat_call,
        seed=seed, device="cpu",
    )
    jax_draw["eps"] = _jax_eps(seed, len(coords), len(SITES) * 3)
    jc, jf = jaug.fused_map_apply(
        jnp.asarray(coords), jnp.asarray(forces), KBT, JLinearMap(cmap_ext), JLinearMap(fmap_ext)
    )
    pc, pf = paug.fused_map_apply(
        torch.as_tensor(coords), torch.as_tensor(forces), KBT,
        TLinearMap(cmap_ext, device="cpu"), TLinearMap(fmap_ext, device="cpu"),
    )
    _close_scaled(pc.numpy(), jc)
    _close_scaled(pf.numpy(), jf)
    bad = torch.as_tensor(forces).clone()
    bad[0, 0, 0] = float("nan")
    with pytest.raises(ValueError, match="NaN handling"):
        paug.fused_map_apply(
            torch.as_tensor(coords), bad, KBT,
            TLinearMap(cmap_ext, device="cpu"), TLinearMap(fmap_ext, device="cpu"),
        )


def test_torch_draws_are_standard_normal():
    """Sampled noise: mean 0 and variance ``var``, each within 5 standard
    errors, on tensor and numpy inputs."""
    var = 0.05
    n = 4000 * 2 * 3
    for source in (np.zeros((4000, 2, 3), np.float32), torch.zeros((4000, 2, 3))):
        drawn = TCondNormal(cov=var, seed=123, device="cpu").sample(source)
        assert drawn.shape == (4000, 2, 3) and isinstance(drawn, type(source))
        out = torch.as_tensor(drawn)
        mean, sample_var = float(out.mean()), float(out.var())
        assert abs(mean) <= 5 * np.sqrt(var / n)
        assert abs(sample_var - var) <= 5 * var * np.sqrt(2 / (n - 1))


def test_generator_advances_and_astype_keeps_state():
    """Each draw advances the generator; ``astype`` carries its state on
    (the next draw, in the new dtype, is the second draw of the seed)."""
    source = torch.zeros((6, 2, 3))
    aug = TCondNormal(cov=0.1, seed=3, device="cpu")
    first = aug.sample(source)
    assert not torch.equal(first, aug.sample(source))
    aug = TCondNormal(cov=0.1, seed=3, device="cpu")
    torch.testing.assert_close(aug.sample(source), first, rtol=0, atol=0)
    cast = aug.astype(np.float64)
    gen = pgauss.make_generator(3, torch.device("cpu"))
    torch.randn((6, 6), generator=gen)
    expect = np.sqrt(0.1) * torch.randn((6, 6), generator=gen, dtype=torch.float64)
    got = cast.sample(np.zeros((6, 2, 3)))
    assert got.dtype == np.float64
    np.testing.assert_allclose(got.reshape(6, 6), expect.numpy(), rtol=1e-15, atol=0)


@pytest.mark.parametrize("arrays", ["tensor", "numpy"])
def test_fused_and_piecewise_augmentation_draw_alike(system, arrays):
    """Same seed: the fused augmentation and sample() + log_gradient() take
    the same draw. Coordinates are equal; forces agree to float32 rounding
    ((y - Mx)/var against sqrt(var)/var * eps)."""
    coords, forces, cmat = system

    def augmenter():
        premap = TLinearMap(cmat, bypass_nan_check=True, device="cpu").flat_call
        return TCondNormal(cov=VAR, premap=premap, seed=21, device="cpu")

    tc, tf = torch.as_tensor(coords), torch.as_tensor(forces)
    fused = augmenter().fused_augment(tc, tf, KBT)
    aug = augmenter()
    piece_in = (tc, tf) if arrays == "tensor" else (coords, forces)
    y = aug.sample(piece_in[0])
    real, virt = aug.log_gradient(piece_in[0], y)
    piece_c = np.concatenate([coords, np.asarray(y)], axis=1)
    piece_f = np.concatenate([forces + KBT * np.asarray(real), KBT * np.asarray(virt)], axis=1)
    np.testing.assert_array_equal(fused[0].numpy(), piece_c)
    np.testing.assert_allclose(fused[1].numpy(), piece_f, atol=1e-3, rtol=1e-5)
    # and AugmentedTrajectory takes the fused path for tensors
    traj = AugmentedTrajectory(coords=tc, forces=tf, augmenter=augmenter(), kbt=KBT)
    torch.testing.assert_close(traj.coords, fused[0], rtol=0, atol=0)
    torch.testing.assert_close(traj.forces, fused[1], rtol=0, atol=0)


def test_downcast_and_float64_tensors():
    aug = TCondNormal(cov=0.1, seed=1, device="cpu")
    assert isinstance(aug.to_SimpleCondNormal(), SimpleCondNormal)
    with pytest.raises(ValueError):
        TCondNormal(cov=0.1, premap=torch.sin, device="cpu").to_SimpleCondNormal()
    # float64 tensors stay float64 (the JAX package computes float32 unless
    # jax_enable_x64 is set)
    out = aug.sample(torch.zeros((3, 2, 3), dtype=torch.float64))
    assert out.dtype == torch.float64
