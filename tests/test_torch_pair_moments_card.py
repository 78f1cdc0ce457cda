"""Constraint detection's pair-moment kernel (``csrc/pair_moments.cu``) on
the CUDA card: against the plain torch path on the same tensors, against
float64 detection on the ``cln025_ca`` benchmark system (175 atoms, 30
rigid pairs, 10,000 frames), bit for bit from run to run, one launch a
detection.

Needs a card; skips without one. Nothing here imports JAX, which
``tests/conftest.py`` does, so on a host without JAX run them without it:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_pair_moments_card.py
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from aggforce_torch.constraints import finder
from benchmark.reference import detect
from benchmark.systems import build_system, make_pool

pytestmark = pytest.mark.cuda

CONFIG = Path(__file__).resolve().parent.parent / "benchmark/configs/cln025_ca.json"
N_FRAMES = 10_000
U = 2.0**-24  # fp32 unit roundoff


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def coords(card):
    """The ``cln025_ca`` cell's frames on the card, centred per frame as the
    finder centres them."""
    system = build_system(json.loads(CONFIG.read_text()))
    xyz, _ = make_pool(system, N_FRAMES, seed=2147483901, device=card)
    return xyz - xyz.mean(dim=1, keepdim=True)


def _mean_square_and_range(x, other, chunk=512):
    """Per pair, the float64 mean of (d - d0)^2 over the frames, with the
    plain path's fp32 distances, and the largest distance of any frame."""
    d0 = finder._dists(x[:1], other[:1])[0]
    ms = torch.zeros(d0.shape, dtype=torch.float64, device=x.device)
    dmax = 0.0
    for lo in range(0, x.shape[0], chunk):
        d = finder._dists(x[lo : lo + chunk], other[lo : lo + chunk])
        dmax = max(dmax, float(d.max()))
        delta = (d - d0).double()
        ms += (delta * delta).sum(dim=0)
    return ms / x.shape[0], dmax


def _case(coords, name):
    """(xyz, other or None) of a named case."""
    if name == "cell":
        return coords, None
    if name == "cross":  # sites 100-139 shifted rigidly: each is bound to its twin
        shift = torch.tensor([0.3, 0.0, 0.0], device=coords.device)
        return coords, (coords[:, 100:140] + shift).contiguous()
    t = {"one_frame": 1, "ten_frames": 10, "ragged": 1237}[name]
    return coords[:t].contiguous(), None


@pytest.mark.parametrize("name", ["cell", "cross", "one_frame", "ten_frames", "ragged"])
def test_sd_matches_the_plain_path(coords, name):
    """The kernel's sd against ``_distance_sd`` on the same card tensor.

    Both take the same fp32 distances (up to one rounding of the sum of
    squares, which the kernel takes with FMAs) and differ in how they add
    the moments: the plain path in fp32, in chunk sums of up to 64 frames
    added chunk by chunk, the kernel in fp64. A chain of m fp32 additions
    of terms of size up to s is off by at most m u s, so with the mean
    square fluctuation ms = s2 / T each of s2 / T and mean^2 is off by at
    most m u ms, m = 64 + ceil(T / 64) + 2; the distances' rounding adds
    4 u dmax |delta| to each delta squared. Hence, per pair,
    |sd_k^2 - sd_p^2| <= 3 m u ms + 8 u dmax sqrt(ms).
    """
    x, other = _case(coords, name)
    o = x if other is None else other
    t = x.shape[0]
    sd_k, hits = finder.pair_moments(x, other)
    sd_p = finder._distance_sd(x, o, finder._chunk_length(t, x.shape[1], o.shape[1]))
    ms, dmax = _mean_square_and_range(x, o)
    m = 64 + -(-t // 64) + 2
    limit = 3 * m * U * ms + 8 * U * dmax * ms.sqrt()
    gap = (sd_k.square() - sd_p.double().square()).abs()
    assert sd_k.shape == sd_p.shape == hits.shape
    assert sd_k.dtype == torch.float64 and hits.dtype == torch.bool
    worst = float((gap / limit.clamp_min(1e-300)).max())
    assert bool((gap <= limit).all()), f"worst gap {worst:.3g} of its limit"
    expect = sd_k < 1e-3
    if other is None:
        expect.fill_diagonal_(False)
    assert torch.equal(hits, expect)
    if t == 1:
        assert not bool(sd_k.any())


def test_mask_equals_float64_detection(coords):
    """Detection on the card finds the float64 reference's pairs, which are
    the system's 30 rigid ones."""
    system = build_system(json.loads(CONFIG.read_text()))
    found = finder.guess_pairwise_constraints(coords)
    ref = detect.detect(coords, "float64")
    assert {tuple(sorted(p)) for p in found} == ref
    assert ref == set(system.pairs)


def test_within_sd_is_symmetric_with_a_zero_diagonal(coords):
    """Within one system the finalize launch computes each upper pair once
    and writes its mirror: sd equals its transpose bit for bit, and the
    diagonal is 0 and never a hit."""
    sd, hits = finder.pair_moments(coords[:2000].contiguous())
    assert torch.equal(sd.view(torch.int64), sd.T.view(torch.int64))
    assert torch.equal(hits, hits.T)
    assert not bool(sd.diagonal().any()) and not bool(hits.diagonal().any())


def test_frame_split_fills_the_card(card):
    """The C side picks the frame slices F from the card's SM count: at the
    cell's 175 sites (21 upper tiles) enough that the grid covers every SM,
    one when the tiles alone do (1,500 sites), never more than the frames;
    sizes the kernels do not take give 0."""
    slices = finder._pair_moments_lib().aggforce_pair_moments_slices
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    f = slices(N_FRAMES, 175, 175, 1)
    assert 21 * f >= sms and f <= N_FRAMES
    assert slices(256, 1_500, 1_500, 1) == 1
    assert 1 <= slices(10, 175, 175, 1) <= 10
    assert slices(1, 175, 175, 1) == 1
    assert slices(0, 175, 175, 1) == 0
    assert slices(N_FRAMES, 175, 40, 1) == 0


@pytest.mark.parametrize("name", ["cell", "cross"])
def test_two_calls_give_identical_bits(coords, name):
    x, other = _case(coords, name)
    sd1, hits1 = finder.pair_moments(x, other)
    sd2, hits2 = finder.pair_moments(x, other)
    assert torch.equal(sd1.view(torch.int64), sd2.view(torch.int64))
    assert torch.equal(hits1, hits2)


def test_one_detection_is_one_launch(coords):
    """Every card input to the finder goes through the kernel, once a call:
    a card tensor, numpy with ``device="cuda"``, cross mode, and strided
    tensors and arrays (their centred copies keep the strides)."""
    finder.pair_moments.launches = 0
    found = finder.guess_pairwise_constraints(coords[:500])
    assert finder.pair_moments.launches == 1
    finder.guess_pairwise_constraints(coords[:500].cpu().numpy(), device="cuda")
    assert finder.pair_moments.launches == 2
    finder.guess_pairwise_constraints(coords[:500], cross_xyz=coords[:500, :40])
    assert finder.pair_moments.launches == 3
    strided = coords[:500].permute(1, 2, 0).contiguous().permute(2, 0, 1)
    assert not strided.is_contiguous()
    assert finder.guess_pairwise_constraints(strided) == found
    assert finder.guess_pairwise_constraints(strided.cpu().numpy(), device="cuda") == found
    assert finder.guess_pairwise_constraints(strided, cross_xyz=strided[:, :40])
    assert finder.pair_moments.launches == 6


@pytest.mark.parametrize("bad", ["float64", "strided", "frames"])
def test_card_input_outside_the_contract_raises(coords, bad):
    """No fall back to the plain path on the card: the wrapper raises."""
    x = coords[:64]
    other = None
    if bad == "float64":
        x = x.double()
    elif bad == "strided":
        x = x.transpose(0, 1).contiguous().transpose(0, 1)
    else:
        other = coords[:63, :40].contiguous()
    before = finder.pair_moments.launches
    with pytest.raises(ValueError):
        finder.pair_moments(x, other)
    assert finder.pair_moments.launches == before


def test_mask_matches_numpy_twin_on_a_small_system(card):
    """A 12-site system with two rigid pairs, run through numpy and the card."""
    rng = np.random.default_rng(3)
    base = rng.normal(scale=0.8, size=(12, 3))
    xyz = (base[None] + 0.05 * rng.normal(size=(240, 12, 3))).astype(np.float32)
    xyz[:, 1] = xyz[:, 0] + np.float32([0.15, 0.0, 0.0])
    xyz[:, 5] = xyz[:, 4] + np.float32([0.0, 0.2, 0.0])
    on_card = finder.guess_pairwise_constraints(torch.as_tensor(xyz, device=card))
    assert on_card == finder.guess_pairwise_constraints(xyz, device="cpu")
    assert on_card == {frozenset((0, 1)), frozenset((4, 5))}
