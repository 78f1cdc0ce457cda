"""The rank-2 apply on the CUDA card, at the solvated 1,500-atom system's
shape (66 sites, 1,500 atoms) cut to 4,096 frames.

Needs a card; skips without one. Nothing here imports JAX, which
``tests/conftest.py`` does, so on a host without JAX run them without it:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_linear_apply_card.py
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from aggforce_torch.map import SeperableTMap, TLinearMap
from aggforce_torch.ops import torchcore

pytestmark = pytest.mark.cuda

N_FRAMES, N_ATOMS, N_SITES = 4096, 1500, 66
LIMITS = Path(__file__).resolve().parent.parent / "benchmark/limits/solvated_1500.linear.json"


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def problem(card):
    """Forces on the card at the cell's scale and a dense (66, 1,500) map
    with a few atoms of zero weight."""
    gen = torch.Generator(device=card).manual_seed(16)
    forces = 60.0 * torch.randn(N_FRAMES, N_ATOMS, 3, generator=gen, device=card)
    rng = np.random.default_rng(16)
    matrix = rng.normal(size=(N_SITES, N_ATOMS)) / np.sqrt(N_ATOMS)
    matrix[:, :10] = 0.0
    return forces, matrix


def _apply_err(mapped, forces, matrix):
    """Largest error against a float64 product over the product's RMS, as
    the benchmark's linear check reads it."""
    exact = torch.einsum(
        "mn,tnd->tmd", torch.as_tensor(matrix, device=forces.device), forces.double()
    )
    rms = exact.square().mean().sqrt()
    return float((mapped.double() - exact).abs().max() / rms)


def test_apply_matches_float64_within_the_cell_limit(problem, monkeypatch):
    """One chunk and several (a lowered budget, the last chunk ragged):
    both within the cell's ``apply_err`` limit, and within fp32 rounding
    of each other."""
    forces, matrix = problem
    tmap = TLinearMap(mapping=matrix, device=forces.device)
    limit = json.loads(LIMITS.read_text())["limits"]["apply_err"]
    whole = tmap(forces)
    monkeypatch.setattr(torchcore, "_LAYOUT_BYTES", 1000 * N_ATOMS * 3 * 4)
    chunked = tmap(forces)
    for mapped in (whole, chunked):
        assert mapped.shape == (N_FRAMES, N_SITES, 3) and mapped.is_contiguous()
        assert mapped.dtype == torch.float32 and mapped.device == forces.device
        assert _apply_err(mapped, forces, matrix) < limit
    scale = float(whole.abs().max())
    torch.testing.assert_close(chunked, whole, rtol=0, atol=1e-5 * scale)


@pytest.mark.parametrize("api", ["legacy", "new"])
def test_apply_is_bitwise_equal_with_process_tf32(problem, api):
    """The products stay full fp32 whatever the process's TF32 switch says."""
    forces, matrix = problem
    tmap = TLinearMap(mapping=matrix, device=forces.device)
    sep = SeperableTMap(coord_map=tmap, force_map=tmap)
    off = tmap(forces)
    matmul = torch.backends.cuda.matmul
    try:
        if api == "legacy":
            torch.set_float32_matmul_precision("high")
        else:
            matmul.fp32_precision = "tf32"
        on = tmap(forces)
        on_sep = sep.map_arrays(forces, forces)
    finally:
        if api == "legacy":
            torch.set_float32_matmul_precision("highest")
        else:
            matmul.fp32_precision = "ieee"
    torch.testing.assert_close(on, off, rtol=0, atol=0)
    for out in on_sep:
        torch.testing.assert_close(out, off, rtol=0, atol=0)


@pytest.mark.parametrize("atom, raises", [(3, False), (700, True)])
def test_nan_verdict_on_the_card(problem, atom, raises):
    """A NaN on a zero-weight atom is filled, on a weighted one it raises."""
    forces, matrix = problem
    tmap = TLinearMap(mapping=matrix, device=forces.device)
    bad = forces.clone()
    bad[N_FRAMES - 1, atom, 2] = float("nan")
    if raises:
        with pytest.raises(ValueError):
            tmap(bad)
        return
    filled = bad.nan_to_num(nan=0.0)
    torch.testing.assert_close(tmap(bad), tmap(filled), rtol=0, atol=0)
