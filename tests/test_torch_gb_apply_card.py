"""The featurized apply's kernel (``csrc/gb_apply.cu``) on the CUDA card:
against the float64 formula (``ops.gb_apply.gb_apply_witness``) under its
derived fp32 bound, at the ``cln025_ca`` shape (10,000 frames, S 10, G 145,
n_basis 7) and the ``solvated_1500`` one (2,048 frames, S 66, G 1,125), each
with its fitted map; against the plain torch path on the card; bit for bit
from run to run; one launch a call; NaN frames; the clip rule's edge; maps
without the id block; and a blocked map applied to a 20,000-frame window in
one call within a peak-memory ceiling.

Needs a card; skips without one. Nothing here imports JAX, which
``tests/conftest.py`` does, so on a host without JAX run them without it:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_gb_apply_card.py
"""

import dataclasses
import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

import aggforce_torch as agg
from aggforce_torch.ops.gb_apply import gb_apply, gb_apply_witness, workspace_bytes
from aggforce_torch.qp import fusedfeat as pff
from benchmark.systems import build_system, make_pool

pytestmark = pytest.mark.cuda

CONFIGS = Path(__file__).resolve().parent.parent / "benchmark/configs"
U = 2.0**-24  # fp32 unit roundoff
SEED = 2147483951
FRAMES = {"cln025_ca": 10_000, "solvated_1500": 2_048}
WINDOW = 20_000  # a solvated_1500.feat_blocked fit's window
# what a call may add to the card's peak beyond its workspace
# (``gb_apply.workspace_bytes``: at 20,000 frames x 66 x 1,125 the fp64
# group planes 1.08 GB, the fp64 slice sums 63 MB, cg and output 32 MB):
# the caching allocator's rounding of its four blocks to 2 MiB. The plain
# path needs ~24 GiB per 4,096 frames.
ALLOCATOR_SLACK_BYTES = 4 * (2 << 20)


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _spec(cfg, **changes):
    f = cfg["featurizer"]
    spec = pff.GBFeatSpec(
        outer=f["outer"], inner=f["inner"], n_basis=f["n_basis"], width=f["width"],
        dist_power=f["dist_power"], clip=f["clip"],
    )
    return dataclasses.replace(spec, **changes)


def _cell(name, card, n_frames):
    """(system, cfg, coords, forces, cmap) of a benchmark configuration's
    frames on the card."""
    cfg = json.loads((CONFIGS / f"{name}.json").read_text())
    system = build_system(cfg)
    coords, forces = make_pool(system, n_frames, seed=SEED, device=card)
    cmap = agg.LinearMap([[s] for s in system.sites], n_fg_sites=system.n_atoms)
    return system, cfg, coords, forces, cmap


def _fit(name, card):
    """The cell's fitted map on its frames: the fused fit at ``cln025_ca``,
    the site-blocked fit (blocks of 6) at ``solvated_1500``."""
    system, cfg, coords, forces, cmap = _cell(name, card, FRAMES[name])
    kw = dict(
        kbt=system.kbt, spec=_spec(cfg), constraints={frozenset(p) for p in system.pairs},
        l2_regularization=cfg["l2_regularization"],
        n_constraint_frames=cfg["n_constraint_frames"],
        constraint_rng=np.random.default_rng(7), device=card,
    )
    traj = agg.Trajectory(coords=coords, forces=forces)
    if name == "cln025_ca":
        tmap = pff.fused_gb_linear_map(traj, cmap, **kw)
    else:
        tmap = agg.qp.fused_gb_linear_map_blocked(
            traj, cmap, chunk_size=cfg["chunk_size"], site_block=cfg["site_block"], **kw
        )
    return system, coords, forces, tmap.force_map


@pytest.fixture(scope="module", params=sorted(FRAMES))
def fitted(request, card):
    return request.param, *_fit(request.param, card)


def _witness(fmap, coords, forces, kbt=None, fp32_geometry=False):
    """``gb_apply_witness`` of ``fmap`` at the centers the kernel takes."""
    return gb_apply_witness(
        forces, coords, fmap._coefs, fmap._cmap_mat, fmap._onehot, fmap._counts,
        pff.exact_centers(fmap._host_geometry[1], fmap._spec),
        fmap._kbt if kbt is None else kbt, fmap._spec,
        frame_chunk=32 if fmap._onehot.shape[1] > 500 else 256,
        fp32_geometry=fp32_geometry,
    )


def _plain(fmap, coords, forces, step=1024):
    """The plain torch path on the card, in ``step``-frame chunks."""
    return torch.cat([
        pff._fused_apply(
            forces[lo : lo + step], coords[lo : lo + step], fmap._coefs, fmap._cmap_mat,
            fmap._group_mean, fmap._onehot, fmap._counts, fmap._centers, fmap._kbt,
            fmap._spec,
        )
        for lo in range(0, forces.shape[0], step)
    ])


def _plain_limit(fmap, coords, forces, bound):
    """|kernel - plain| may reach the kernel's bound plus the plain path's:
    the witness's bound for fp32 geometry and the plain path's fp32 sums
    over N atoms and G (K + 1) coefficients, n u ``scale``, doubled."""
    _, plain_bound, scale = _witness(fmap, coords, forces, fp32_geometry=True)
    n_atoms, g = fmap._onehot.shape
    n_terms = n_atoms + g * (fmap._spec.n_basis + 1)
    return bound + plain_bound + 2.0 * n_terms * U * scale


def test_kernel_matches_the_float64_formula(fitted):
    """Every mapped-force component within the witness's derived bound of
    the float64 formula; the formula without its divergence term (a kernel
    that dropped it) is not. The kernel's largest error over the rms force
    lies under the plain path's on the same frames (its geometry is fp64)."""
    name, system, coords, forces, fmap = fitted
    out = fmap(forces, coords)
    value, bound, _ = _witness(fmap, coords, forces)
    gap = (out.double() - value).abs()
    worst = float((gap / bound).max())
    rms = float(value.square().mean().sqrt())
    head = 2048
    plain_err = float((_plain(fmap, coords[:head], forces[:head], 256).double() - value[:head]).abs().max())
    print(f"{name}: worst gap {worst:.3g} of its bound; max gap / rms: kernel "
          f"{float(gap.max()) / rms:.3g}, on the first {head} frames kernel "
          f"{float(gap[:head].max()) / rms:.3g}, plain {plain_err / rms:.3g}")
    assert out.shape == value.shape and out.dtype == torch.float32
    assert bool((gap <= bound).all()), f"{name}: worst gap {worst:.3g} of its bound"
    assert float(gap[:head].max()) < plain_err
    no_div, _, _ = _witness(fmap, coords[:256], forces[:256], kbt=0.0)
    assert not bool(((no_div - value[:256]).abs() <= bound[:256]).all())


def test_kernel_matches_the_plain_path_on_the_card(fitted):
    name, system, coords, forces, fmap = fitted
    t = min(forces.shape[0], 2048)
    out = fmap(forces[:t], coords[:t])
    plain = _plain(fmap, coords[:t], forces[:t], step=256 if t <= 2048 else 1024)
    _, bound, _ = _witness(fmap, coords[:t], forces[:t])
    gap = (out.double() - plain.double()).abs()
    limit = _plain_limit(fmap, coords[:t], forces[:t], bound)
    assert bool((gap <= limit).all()), f"{name}: worst {float((gap / limit).max()):.3g}"


def test_two_calls_give_identical_bits(fitted):
    _, _, coords, forces, fmap = fitted
    first = fmap(forces, coords)
    second = fmap(forces, coords)
    assert torch.equal(first.view(torch.int32), second.view(torch.int32))


def test_one_launch_per_call(fitted):
    """A tensor call is one launch whatever its length; numpy frames go up
    in chunks of ``_APPLY_CHUNK``, one launch each."""
    _, _, coords, forces, fmap = fitted
    before = gb_apply.launches
    out = fmap(forces, coords)
    assert isinstance(out, torch.Tensor) and out.device.type == "cuda"
    assert gb_apply.launches == before + 1
    t = min(forces.shape[0], 10_000)
    out_np = fmap(forces[:t].cpu().numpy(), coords[:t].cpu().numpy())
    assert isinstance(out_np, np.ndarray) and out_np.shape == (t, *out.shape[1:])
    assert gb_apply.launches == before + 1 + math.ceil(t / fmap._APPLY_CHUNK)


def test_nan_frames_map_to_nan_as_on_the_plain_path(fitted):
    """A NaN coordinate or force makes the same outputs NaN as on the plain
    path: a whole frame for a coordinate, that component for a force."""
    _, _, coords, forces, fmap = fitted
    x, f = coords[:64].clone(), forces[:64].clone()
    x[3, 5, 1] = float("nan")
    f[10, 7, 2] = float("nan")
    x[20, 0, :] = float("nan")
    f[30, :, 0] = float("nan")
    out = fmap(f, x)
    plain = _plain(fmap, x, f)
    assert torch.equal(torch.isnan(out), torch.isnan(plain))
    assert bool(torch.isnan(out[3]).all()) and bool(torch.isnan(out[20]).all())
    assert bool(torch.isnan(out[10, :, 2]).all()) and not bool(torch.isnan(out[10, :, :2]).any())
    clean = [i for i in range(64) if i not in (3, 10, 20, 30)]
    assert not bool(torch.isnan(out[clean]).any())


def test_map_without_the_id_block(card):
    """``include_id=False``: coefficients are (S, G n_basis), and the kernel
    holds to the float64 formula and the plain path at the cln025_ca shape
    (seeded coefficients of the fitted maps' size)."""
    system, cfg, coords, forces, cmap = _cell("cln025_ca", card, 2_048)
    spec = _spec(cfg, include_id=False)
    geom = pff.group_factorization(cmap, spec, {frozenset(p) for p in system.pairs})
    g = geom["onehot"].shape[1]
    coefs = np.random.default_rng(3).normal(scale=0.3, size=(len(system.sites), g * spec.n_basis))
    fmap = pff.FusedGBMap(
        coefs, cmap.standard_matrix.astype(np.float32), geom["onehot"], geom["centers"],
        system.kbt, spec, device=card,
    )
    out = fmap(forces, coords)
    value, bound, _ = _witness(fmap, coords, forces)
    assert bool(((out.double() - value).abs() <= bound).all())
    plain = _plain(fmap, coords, forces)
    limit = _plain_limit(fmap, coords, forces, bound)
    assert bool(((out.double() - plain.double()).abs() <= limit).all())


def test_the_clip_rule_at_its_edge(card):
    """A basis term contributes its derivative where exp(-off^2) > clip, as
    the float64 reference decides it (off^2 < -ln(clip) on the fp64 offset),
    also where the fp32 exponential rounds onto or past clip. Two atoms,
    the site on atom 0 at the origin and atom 1 at (0.5, 0, 0), each its
    own group; with centers 0, 1, 2 the offset of atom 1 to center 1 is
    exactly -0.5. With clip the float32 just below exp(-0.25) the term is
    live (dphi = raw), with the float32 just above it is not; either way gz
    = max(raw, clip) - clip of the card's expf(-0.25)."""
    raw = float(torch.exp(torch.tensor([-0.25], device=card))[0])
    exact = np.float32(math.exp(-0.25))  # the float32 nearest exp(-0.25)
    if float(exact) > math.exp(-0.25):
        below, above = float(np.nextafter(exact, np.float32(0.0))), float(exact)
    else:
        below, above = float(exact), float(np.nextafter(exact, np.float32(1.0)))
    coords = torch.tensor([[[0.0, 0.0, 0.0], [0.5, 0.0, 0.0]]], device=card)
    forces = torch.tensor([[[1.0, 2.0, 3.0], [0.25, -0.5, 0.75]]], device=card)
    onehot = np.eye(2, dtype=np.float32)
    cmap = np.array([[1.0, 0.0]], dtype=np.float32)
    centers = np.array([0.0, 1.0, 2.0], dtype=np.float32)
    kbt, c_id, c_gb = 0.5, 0.125, 0.75
    coefs = np.zeros((1, 2 * 4), dtype=np.float32)
    coefs[0, 1] = c_id  # atom 1's id weight
    coefs[0, 2 + 1 * 3 + 1] = c_gb  # atom 1's basis function at center 1
    f1 = forces[0, 1].double().cpu()
    x_axis = torch.tensor([1.0, 0.0, 0.0], dtype=torch.float64)
    for clip, live in ((below, True), (above, False)):
        spec = pff.GBFeatSpec(outer=2.0, inner=0.0, n_basis=3, width=1.0, dist_power=1.0, clip=clip)
        fmap = pff.FusedGBMap(coefs, cmap, onehot, centers, kbt, spec, device=card)
        out = fmap(forces, coords)[0, 0].double().cpu()
        gz = max(raw, clip) - clip
        expect = (c_id + gz * c_gb) * f1 + (kbt * c_gb * raw * x_axis if live else 0.0)
        assert torch.allclose(out, expect, rtol=1e-6, atol=0), (clip, live, out, expect)
        value, bound, _ = _witness(fmap, coords, forces)
        assert bool(((out - value[0, 0].cpu()).abs() <= bound[0, 0].cpu()).all())


def test_blocked_map_applies_to_a_window_in_one_call(fitted, card):
    """A 66 x 1,125 x 7 map applies to a 20,000-frame window in
    one launch, adding to what the card held no more than its workspace
    (``workspace_bytes``, about 1.2 GB) and ``ALLOCATOR_SLACK_BYTES``, and
    each 2,048-frame slice of it as a call of that slice alone does, up to
    both calls' rounding (the group split, and so the order of the sums,
    follows the frame count)."""
    name, system, _, _, fmap = fitted
    if name != "solvated_1500":
        pytest.skip("the blocked map is solvated_1500's")
    _, _, coords, forces, _ = _cell(name, card, WINDOW)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    before = gb_apply.launches
    out = fmap(forces, coords)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - held
    assert gb_apply.launches == before + 1
    assert out.shape == (WINDOW, len(system.sites), 3) and bool(torch.isfinite(out).all())
    n_groups = fmap._onehot.shape[1]
    ceiling = workspace_bytes(
        WINDOW, system.n_atoms, len(system.sites), n_groups, fmap._spec.n_basis
    ) + ALLOCATOR_SLACK_BYTES
    assert peak <= ceiling, f"{peak / 2**20:.0f} MiB over a {ceiling / 2**20:.0f} MiB ceiling"
    assert ceiling < 2 << 30
    lo = WINDOW - 2_048
    part = fmap(forces[lo:], coords[lo:])
    _, bound, _ = _witness(fmap, coords[lo:], forces[lo:])
    assert bool(((part.double() - out[lo:].double()).abs() <= 2.0 * bound).all())
