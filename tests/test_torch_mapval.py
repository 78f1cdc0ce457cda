"""Port parity: the map-validation metrics against the JAX package's.

The random offsets are drawn on the host from the caller's numpy generator
in both packages, so the same seed gives the same numbers: the force fields
and the projections must agree to float32 rounding (rtol 1e-5), the numpy
helpers exactly.
"""

import numpy as np
import pytest
import torch

from aggforce_torch import mapval as pmv
from aggforce_torch.utils.synth import synthesize_trajectory

from aggforce_tpu import jaxmapval as jmv

RTOL = 1e-5
KW = dict(inner=0.2, outer=1.2, width=0.5)


@pytest.fixture(scope="module")
def mapped():
    """Coarse-grained-like data: 6 sites, 120 frames."""
    base = np.random.default_rng(4).normal(scale=0.5, size=(6, 3))
    return synthesize_trajectory(base, [frozenset((0, 1))], 120, seed=5)


def test_sq_gaussian_forces_equal_jax(mapped):
    coords, _ = mapped
    got = pmv.sq_gaussian_forces(coords, 0.4, 0.25, device="cpu")
    ref = np.asarray(jmv.sq_gaussian_forces(coords, 0.4, 0.25))
    assert isinstance(got, torch.Tensor) and got.shape == coords.shape
    np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL, atol=RTOL * np.abs(ref).max())
    energies = pmv.sq_gaussian_energies(torch.as_tensor(coords), 0.4, 0.25)
    np.testing.assert_allclose(
        energies.numpy(), np.asarray(jmv.sq_gaussian_energies(coords, 0.4, 0.25)), rtol=RTOL
    )
    one = pmv.rsqpg_forces(coords, randg=np.random.default_rng(3), device="cpu", **KW)
    ref_one = np.asarray(jmv.rsqpg_forces(coords, randg=np.random.default_rng(3), **KW))
    np.testing.assert_allclose(one.numpy(), ref_one, rtol=RTOL, atol=RTOL * np.abs(ref_one).max())


def _jax_fallback(coords, randg, **kw):
    return jmv.rsqpg_forces(coords, randg=randg, **kw)


def _port_fallback(coords, randg, **kw):
    return pmv.rsqpg_forces(coords, randg=randg, device="cpu", **kw)


@pytest.mark.parametrize("metric", ["random_force_proj", "random_residual_shift"])
@pytest.mark.parametrize(
    "route", ["batched", "ragged", "per sample"], ids=lambda r: r.replace(" ", "-")
)
def test_projections_equal_jax(mapped, metric, route):
    """Same numpy seed, same numbers: the batched path (one batch; batches
    of 4 over 10 samples, a ragged last batch) and the per-sample fallback
    of a user-given ``method``."""
    coords, forces = mapped
    kw = dict(n_samples=10, average=False, **KW)
    if route == "ragged":
        kw["batch_size"] = 4
    jkw, pkw = dict(kw), dict(kw, device="cpu")
    if route == "per sample":
        jkw["method"], pkw["method"] = _jax_fallback, _port_fallback
        del pkw["device"]
    got = getattr(pmv, metric)(coords, forces, randg=np.random.default_rng(9), **pkw)
    ref = getattr(jmv, metric)(coords, forces, randg=np.random.default_rng(9), **jkw)
    assert len(got) == 10
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=RTOL * np.abs(ref).max())
    mean = getattr(pmv, metric)(
        coords, forces, randg=np.random.default_rng(9), **dict(pkw, average=True)
    )
    np.testing.assert_allclose(mean, np.mean(got), rtol=1e-6)


def test_numpy_helpers_equal_jax(mapped):
    coords, forces = mapped
    got = pmv.random_uniform_forces(coords, scale=2.0, randg=np.random.default_rng(2))
    ref = jmv.random_uniform_forces(coords, scale=2.0, randg=np.random.default_rng(2))
    np.testing.assert_array_equal(got, ref)
    assert pmv.mscg_ip(forces, got) == jmv.mscg_ip(forces, got)
    on_torch = pmv.mscg_ip(torch.as_tensor(forces), got)
    np.testing.assert_allclose(on_torch, jmv.mscg_ip(forces, got), rtol=RTOL)


def test_projections_need_cuda_unless_told(mapped, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pmv.random_force_proj(*mapped, n_samples=2)
