"""Port parity: the per-site Gram (pack, plain twin, unpack) against the JAX
package's Pallas kernel, run in interpret mode on the CPU, and its oracle."""

import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aggforce_torch.ops import _build
from aggforce_torch.ops import gram as pgram

from aggforce_tpu.ops import pallas_gram as jgram
from aggforce_tpu.qp.fusedfeat import GBFeatSpec, _basis_centers

REPO_ROOT = Path(__file__).resolve().parent.parent
WIDTH, CLIP = 1.0, 1e-3


def _raw(seed, t=16, n=24, s=3, g=5, k=4):
    rng = np.random.default_rng(seed)
    spec = GBFeatSpec(outer=2.0, inner=0.1, n_basis=k, width=WIDTH)
    coords = rng.normal(size=(t, n, 3)).astype(np.float32)
    forces = rng.normal(size=(t, n, 3)).astype(np.float32)
    mask = np.ones(t, np.float32)
    mask[-2:] = 0.0
    cmap = rng.normal(size=(s, n)).astype(np.float32)
    onehot = np.zeros((n, g), np.float32)
    onehot[np.arange(n), np.arange(n) % g] = 1.0
    counts = onehot.sum(0)
    group_mean = (onehot / np.maximum(counts, 1)).T.astype(np.float32)
    centers = _basis_centers(spec).astype(np.float32)
    return (coords, forces, mask, cmap, group_mean, onehot, counts), centers, k


CASES = [
    dict(seed=0),
    dict(seed=1, g=17, k=3, s=1),
    dict(seed=2, t=32, g=16, k=1, s=2),
]


def _packed(case):
    arrays, centers, k = _raw(**case)
    j = jgram.pack_operands(
        *map(jnp.asarray, arrays), np.float32(0.7), k, jnp.asarray(centers)
    )
    p = pgram.pack_operands(
        *map(torch.as_tensor, arrays), 0.7, k, torch.as_tensor(centers)
    )
    return [np.asarray(x) for x in j], p, arrays[2], k


@pytest.mark.parametrize("case", CASES)
def test_pack_operands_matches_jax(case):
    j, p, _, _ = _packed(case)
    for name, a, b in zip(("gpos", "cg", "fg", "centers", "kcounts"), j, p):
        assert b.is_contiguous(), name
        np.testing.assert_allclose(b.numpy(), a, rtol=1e-5, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("case", CASES)
def test_plain_gram_matches_oracle_and_pallas(case):
    j, p, mask, k = _packed(case)
    gpos, cg, fg, cf, kc = p
    got = pgram.site_grams_plain(
        gpos, cg, fg, torch.as_tensor(mask), cf, kc, k, WIDTH, CLIP, t_chunk=5
    ).numpy()
    oracle = jgram.reference_site_grams(*j[:3], mask, *j[3:], k, WIDTH, CLIP)
    pallas = np.asarray(jgram.pallas_site_grams(
        *map(jnp.asarray, j[:3]), jnp.asarray(mask), *map(jnp.asarray, j[3:]),
        n_basis=k, width=WIDTH, clip=CLIP, t_block=8, interpret=True,
    ))
    for expect in (oracle, pallas):
        scale = np.abs(expect).max() + 1.0
        np.testing.assert_allclose(got, expect, atol=3e-4 * scale)


@pytest.mark.parametrize("g, nb, g_pad, s", [(5, 3, 8, 2), (17, 7, 32, 3), (16, 4, 16, 1)])
def test_unpack_gram_bit_identical_to_jax(g, nb, g_pad, s):
    n = (1 + nb) * g_pad
    x = np.random.default_rng(g).normal(size=(s, n, n)).astype(np.float32)
    expect = np.asarray(jgram.unpack_gram(jnp.asarray(x), g, nb))
    np.testing.assert_array_equal(pgram.unpack_gram(torch.as_tensor(x), g, nb).numpy(), expect)


def test_cpu_tensors_take_the_plain_version(monkeypatch):
    """A CPU tensor never reaches the kernel library, and counts no launch."""
    _, p, mask, k = _packed(CASES[0])
    gpos, cg, fg, cf, kc = p

    def no_library(*_args, **_kwargs):
        raise AssertionError("the CUDA library must not be loaded for CPU tensors")

    monkeypatch.setattr(_build, "load", no_library)
    monkeypatch.setattr(pgram.site_grams, "launches", 0)
    args = (gpos, cg, fg, torch.as_tensor(mask), cf, kc, k, WIDTH, CLIP)
    got = pgram.site_grams(*args)
    assert pgram.site_grams.launches == 0
    torch.testing.assert_close(got, pgram.site_grams_plain(*args), rtol=0, atol=0)


def _bad_operands(kind):
    _, p, mask, k = _packed(CASES[0])
    gpos, cg, fg, cf, kc = p
    mask = torch.as_tensor(mask)
    if kind == "dtype":
        fg = fg.double()
    elif kind == "contiguity":
        cg = cg.transpose(1, 2).contiguous().transpose(1, 2)
    elif kind == "g_pad":
        gpos, fg = gpos[..., :8].contiguous(), fg[..., :8].contiguous()
    elif kind == "mask":
        mask = mask[:-1]
    elif kind == "params":
        cf = cf[:-1]
    return gpos, cg, fg, mask, cf, kc, k, WIDTH, CLIP


@pytest.mark.parametrize("kind", ["dtype", "contiguity", "g_pad", "mask", "params"])
def test_wrapper_rejects_what_the_kernel_does_not_take(kind):
    with pytest.raises(ValueError):
        pgram.site_grams(*_bad_operands(kind))


def test_gram_module_imports_without_nvcc(tmp_path):
    """Importing the wrapper neither needs nvcc nor builds anything."""
    code = (
        "import aggforce_torch.ops.gram, aggforce_torch.ops._build as b\n"
        "import sys; sys.exit(0 if b.last_build['seconds'] == 0.0 else 1)\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO_ROOT, capture_output=True,
        text=True, timeout=120, env={"PATH": str(tmp_path), "HOME": str(tmp_path)},
    )
    assert proc.returncode == 0, proc.stderr



def test_build_without_nvcc_raises_and_leaves_nothing(monkeypatch, tmp_path):
    monkeypatch.setattr(_build.shutil, "which", lambda _name: None)
    monkeypatch.setattr(_build, "NVCC_FALLBACK", tmp_path / "no-nvcc")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build_all()
    assert list((tmp_path / "build").iterdir()) == []


def test_library_name_follows_source_and_flags(monkeypatch, tmp_path):
    """A changed kernel source or flag set never loads a stale library."""
    src = tmp_path / "k.cu"
    src.write_text("// one\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    first = _build.library_path("k.cu")
    assert first == _build.library_path("k.cu")
    src.write_text("// two\n")
    second = _build.library_path("k.cu")
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-lineinfo",))
    third = _build.library_path("k.cu")
    assert len({first, second, third}) == 3
    assert first.parent == _build.BUILD_DIR and first.suffix == ".so"


def test_library_name_follows_headers(monkeypatch, tmp_path):
    """An edit of a shared header never loads a library built before it."""
    (tmp_path / "k.cu").write_text('#include "shared.cuh"\n')
    header = tmp_path / "shared.cuh"
    header.write_text("// one\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    first = _build.library_path("k.cu")
    header.write_text("// two\n")
    assert _build.library_path("k.cu") != first


def test_both_kernel_sources_are_built():
    assert set(_build.SOURCES) == {"site_grams.cu", "site_grams_tiled.cu"}
    for src in _build.SOURCES:
        assert (_build.CSRC / src).is_file()
