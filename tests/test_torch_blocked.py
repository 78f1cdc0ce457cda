"""Port parity: the site-blocked sweep-scale fit and its tiled Gram against
the JAX package (the Pallas tiled kernel in interpret mode on the CPU, its
float64 oracle, and the blocked fit)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import aggforce_torch as pt
from aggforce_torch.ops import _build
from aggforce_torch.ops import gram as pgram
from aggforce_torch.qp import fusedfeat as pff
from aggforce_torch.utils.synth import synthesize_trajectory

import aggforce_tpu as jt
from aggforce_tpu.ops import pallas_gram as jgram
from aggforce_tpu.qp import fusedfeat as jff
from aggforce_tpu.trajectory import Trajectory as JTrajectory

WIDTH, CLIP, KBT = 1.0, 1e-3, 0.7


def _operands(seed, t=16, n=24, s=3, g=5, k=4):
    """Packed tiled-Gram operands (numpy) from random geometry, with the
    last two frames masked, in both the flat and the raw parameter form."""
    rng = np.random.default_rng(seed)
    coords = rng.normal(size=(t, n, 3)).astype(np.float32)
    forces = rng.normal(size=(t, n, 3)).astype(np.float32)
    mask = np.ones(t, np.float32)
    mask[-2:] = 0.0
    cmap = rng.normal(size=(s, n)).astype(np.float32)
    onehot = np.zeros((n, g), np.float32)
    onehot[np.arange(n), np.arange(n) % g] = 1.0
    counts = onehot.sum(0)
    group_mean = (onehot / counts).T.astype(np.float32)
    centers = np.linspace(0.1, 2.0, k).astype(np.float32)
    gpos, cg, fg, cf, kc = (
        np.array(x)
        for x in jgram.pack_operands(
            *map(jnp.asarray, (coords, forces, mask, cmap, group_mean, onehot, counts)),
            np.float32(KBT), k, jnp.asarray(centers),
        )
    )
    kbt_counts = kc[: gpos.shape[2]].copy()
    return (gpos, cg, fg, mask, centers, kbt_counts), (cf, kc), k


CASES = [
    dict(seed=0),
    dict(seed=1, g=17, k=3, s=1),
    dict(seed=2, t=32, g=16, k=1, s=2),
]


def _port_args(raw, k):
    return (*map(torch.as_tensor, raw), k, WIDTH, CLIP)


@pytest.mark.parametrize("case", CASES)
def test_tiled_plain_matches_pallas_and_oracle(case):
    """Tiles, and the mirrored square, against the JAX tiled kernel (interpret
    mode) and the float64 oracle: atol 3e-4 * (max|expect| + 1), the bound
    of the JAX package's own tiled-kernel test."""
    raw, (cf, kc), k = _operands(**case)
    gpos, cg, fg, mask, centers, kbt_counts = raw
    tiles = pgram.site_grams_tiled_plain(*_port_args(raw, k), t_chunk=5)
    square = pgram.mirror_tiles(tiles, k).numpy()
    oracle = jgram.reference_site_grams(gpos, cg, fg, mask, cf, kc, k, WIDTH, CLIP)
    pallas = np.asarray(jgram.pallas_site_grams_tiled(
        *map(jnp.asarray, raw), n_basis=k, width=WIDTH, clip=CLIP, t_block=8,
        interpret=True,
    ))
    for expect in (oracle, pallas):
        np.testing.assert_allclose(square, expect, atol=3e-4 * (np.abs(expect).max() + 1.0))
    g_pad = gpos.shape[2]
    atol = 3e-4 * (np.abs(oracle).max() + 1.0)
    for p, (i, j) in enumerate(pgram.block_pairs(k)):
        block = oracle[:, i * g_pad:(i + 1) * g_pad, j * g_pad:(j + 1) * g_pad]
        np.testing.assert_allclose(tiles[:, p].numpy(), block, atol=atol, err_msg=str((i, j)))


@pytest.mark.parametrize("s, nb, g_pad", [(2, 3, 8), (1, 1, 16), (3, 4, 32)])
def test_mirror_tiles_is_the_block_permutation(s, nb, g_pad):
    """The reassembly is pure data movement: bit-identical to placing tile
    (i, j) at block (i, j) and its transpose at block (j, i)."""
    pairs = pgram.block_pairs(nb)
    tiles = np.random.default_rng(nb).normal(size=(s, len(pairs), g_pad, g_pad))
    tiles = tiles.astype(np.float32)
    b = 1 + nb
    expect = np.zeros((s, b * g_pad, b * g_pad), np.float32)
    for p, (i, j) in enumerate(pairs):
        expect[:, i * g_pad:(i + 1) * g_pad, j * g_pad:(j + 1) * g_pad] = tiles[:, p]
        expect[:, j * g_pad:(j + 1) * g_pad, i * g_pad:(i + 1) * g_pad] = (
            tiles[:, p].transpose(0, 2, 1) if i != j else tiles[:, p]
        )
    got = pgram.mirror_tiles(torch.as_tensor(tiles), nb).numpy()
    np.testing.assert_array_equal(got, expect)


def test_cpu_tensors_take_the_plain_tiled_version(monkeypatch):
    """A CPU tensor never reaches the kernel library, and counts no launch."""
    raw, _, k = _operands(0)

    def no_library(*_args, **_kwargs):
        raise AssertionError("the CUDA library must not be loaded for CPU tensors")

    monkeypatch.setattr(_build, "load", no_library)
    monkeypatch.setattr(pgram.site_grams_tiled, "launches", 0)
    args = _port_args(raw, k)
    got = pgram.site_grams_tiled(*args)
    assert pgram.site_grams_tiled.launches == 0
    expect = pgram.mirror_tiles(pgram.site_grams_tiled_plain(*args), k)
    torch.testing.assert_close(got, expect, rtol=0, atol=0)


@pytest.mark.parametrize(
    "kind", ["dtype", "contiguity", "g_pad", "mask", "centers", "kbt_counts", "device"]
)
def test_tiled_wrapper_rejects_what_the_kernel_does_not_take(kind):
    raw, _, k = _operands(0)
    gpos, cg, fg, mask, centers, kbt_counts = map(torch.as_tensor, raw)
    if kind == "dtype":
        fg = fg.double()
    elif kind == "contiguity":
        cg = cg.transpose(1, 2).contiguous().transpose(1, 2)
    elif kind == "g_pad":
        gpos, fg = gpos[..., :8].contiguous(), fg[..., :8].contiguous()
        kbt_counts = kbt_counts[:8].contiguous()
    elif kind == "mask":
        mask = mask[:-1]
    elif kind == "centers":  # flat per-column centers are the other contract
        centers = centers.repeat_interleave(gpos.shape[2])
    elif kind == "kbt_counts":
        kbt_counts = kbt_counts[:-1]
    elif kind == "device":
        gpos, cg, fg = (x.to("meta") for x in (gpos, cg, fg))
    with pytest.raises(ValueError):
        pgram.site_grams_tiled(gpos, cg, fg, mask, centers, kbt_counts, k, WIDTH, CLIP)


def test_assemble_constraint_system_of_a_block_matches_jax():
    """Rows span every site; targets are the block rows' Kronecker rows."""
    rng = np.random.default_rng(4)
    n, s_all, g, k, tc = 12, 4, 6, 3, 5
    constr = rng.normal(size=(tc, n, 3)).astype(np.float32)
    cmap = rng.normal(size=(s_all, n)).astype(np.float32)
    onehot = np.zeros((n, g), np.float32)
    onehot[np.arange(n), np.arange(n) % g] = 1.0
    counts = onehot.sum(0)
    group_mean = (onehot / counts).T.astype(np.float32)
    centers = np.linspace(0.0, 2.0, k).astype(np.float32)
    pad_idx = np.array([2, 3, 3])  # a ragged last block, padded
    sel = np.zeros((3, s_all), np.float32)
    sel[np.arange(3), pad_idx] = 1.0
    arrays = (constr, cmap, group_mean, onehot, counts, centers)
    j_rows, j_b = jff._assemble_constraint_system(
        *map(jnp.asarray, arrays), jff.GBFeatSpec(outer=2.0, n_basis=k), jnp.float32,
        cmap_rows=jnp.asarray(cmap[pad_idx]), site_sel=jnp.asarray(sel),
    )
    p_rows, p_b = pff._assemble_constraint_system(
        *map(torch.as_tensor, arrays), pff.GBFeatSpec(outer=2.0, n_basis=k),
        cmap_rows=torch.as_tensor(cmap[pad_idx]), site_sel=torch.as_tensor(sel),
    )
    assert p_rows.shape == (3, tc * s_all, g * (1 + k))
    np.testing.assert_allclose(p_rows.numpy(), np.asarray(j_rows), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(p_b.numpy(), np.asarray(j_b))


@pytest.mark.parametrize("use_pallas", [True, False], ids=["pallas", "scan"])
def test_blocked_fit_matches_jax(use_pallas):
    """The port's blocked fit (plain tiled Gram on the CPU) against the JAX
    blocked fit with the tiled Pallas kernel (interpret mode) and with its
    XLA scan, on well-conditioned random-normal data: mapped forces within
    atol 2e-3, the JAX package's own bound between those two JAX paths."""
    rng = np.random.default_rng(11)
    coords = rng.normal(size=(60, 8, 3)).astype(np.float32)
    forces = rng.normal(size=(60, 8, 3)).astype(np.float32)
    kw = dict(
        kbt=KBT, constraints={frozenset({1, 2})}, l2_regularization=1.0,
        n_constraint_frames=10, site_block=2,
    )
    jmap = jff.fused_gb_linear_map_blocked(
        JTrajectory(coords=jnp.asarray(coords), forces=jnp.asarray(forces)),
        jt.LinearMap([[0], [4]], n_fg_sites=8),
        spec=jff.GBFeatSpec(outer=1.5, n_basis=4),
        constraint_rng=np.random.default_rng(5), use_pallas=use_pallas, **kw,
    )
    pmap = pff.fused_gb_linear_map_blocked(
        pt.Trajectory(coords=coords, forces=forces),
        pt.LinearMap([[0], [4]], n_fg_sites=8),
        spec=pff.GBFeatSpec(outer=1.5, n_basis=4),
        constraint_rng=np.random.default_rng(5), device="cpu", **kw,
    )
    _, jf = jmap.map_arrays(coords[:20], forces[:20])
    _, pf = pmap.map_arrays(coords[:20], forces[:20])
    np.testing.assert_allclose(pf, np.asarray(jf), atol=2e-3)
    assert pmap.force_map.tags["solver_resid"] <= 1e-4
    assert pmap.force_map.tags["escalated"] == 0


N_ATOMS = 24
GROUPS = [frozenset((i, i + 1)) for i in range(0, 8, 2)]
SITES = [[i] for i in range(0, N_ATOMS, 9)]


@pytest.fixture(scope="module")
def system():
    base = np.random.default_rng(0).normal(scale=0.5, size=(N_ATOMS, 3))
    return synthesize_trajectory(base, GROUPS, 256, seed=3)


def _fit(fit, coords, forces, **kw):
    return fit(
        pt.Trajectory(coords=coords, forces=forces),
        pt.LinearMap(SITES, n_fg_sites=N_ATOMS), kbt=KBT,
        spec=pff.GBFeatSpec(outer=2.0, n_basis=4), constraints=set(GROUPS),
        l2_regularization=1e3, n_constraint_frames=10,
        constraint_rng=np.random.default_rng(7), device="cpu", **kw,
    )


@pytest.fixture(scope="module")
def unblocked(system):
    coords, forces = system
    return _fit(pff.fused_gb_linear_map, coords, forces).map_arrays(coords, forces)[1]


@pytest.mark.parametrize("site_block", [1, 2])
def test_blocked_fit_matches_unblocked(system, unblocked, site_block):
    """Fitting sites in blocks is exact: the same per-site QPs, up to the
    summation order of the Gram (flat vs tiled plain twin), so the mapped
    forces agree within 1e-4 * mean|f| (read: <= 7e-6)."""
    coords, forces = system
    blocked = _fit(pff.fused_gb_linear_map_blocked, coords, forces, site_block=site_block)
    assert blocked.force_map.tags["escalated"] == 0
    np.testing.assert_allclose(
        blocked.map_arrays(coords, forces)[1], unblocked,
        atol=1e-4 * np.abs(unblocked).mean(),
    )


def test_forced_escalation_solves_every_site_in_float64(system, unblocked):
    """resid_tol=-1 sends every site of every block to the float64 host
    oracle; its fit lies within 2e-3 * mean|f| of the float32 one."""
    coords, forces = system
    esc = _fit(pff.fused_gb_linear_map_blocked, coords, forces, site_block=2, resid_tol=-1.0)
    assert esc.force_map.tags["escalated"] == len(SITES)
    assert esc.force_map.tags["solver_resid"] < 1e-6
    np.testing.assert_allclose(
        esc.map_arrays(coords, forces)[1], unblocked, atol=2e-3 * np.abs(unblocked).mean()
    )


@pytest.mark.parametrize("resid_tol", [1e-4, -1.0], ids=["converged", "escalated"])
def test_pipelined_blocks_equal_serial_blocks(system, monkeypatch, resid_tol):
    """The depth-1 pipeline only reorders host work: the coefficients are
    the serial loop's, bit for bit, with and without escalation."""
    coords, forces = system
    coefs = {}
    for flag in ("1", "0"):
        monkeypatch.setenv("AGGFORCE_SWEEP_PIPELINE", flag)
        fit = _fit(
            pff.fused_gb_linear_map_blocked, coords, forces, site_block=1,
            resid_tol=resid_tol,
        )
        coefs[flag] = np.stack(fit.force_map.tags["coef_list"])
    np.testing.assert_array_equal(coefs["1"], coefs["0"])


@pytest.mark.parametrize(
    "kw, error, match",
    [
        ({"mesh": object()}, NotImplementedError, "Queue 1 item 13"),
        ({"use_kernel": True}, ValueError, "CUDA"),
        ({"use_kernel": "yes"}, ValueError, "use_kernel"),
    ],
    ids=["mesh", "kernel-off-card", "bad-option"],
)
def test_blocked_fit_unported_or_bad_options_raise(system, kw, error, match):
    coords, forces = system
    with pytest.raises(error, match=match):
        _fit(pff.fused_gb_linear_map_blocked, coords, forces, **kw)


def test_plain_blocked_fit_equals_auto_fit_on_cpu(system):
    """On the CPU "auto" runs the wrapper's plain twin: use_kernel=False
    gives the same fit up to the frame chunking of the sum."""
    coords, forces = system
    auto = _fit(pff.fused_gb_linear_map_blocked, coords, forces)
    plain = _fit(
        pff.fused_gb_linear_map_blocked, coords, forces, use_kernel=False, chunk_size=64
    )
    f_auto = auto.map_arrays(coords, forces)[1]
    np.testing.assert_allclose(
        plain.map_arrays(coords, forces)[1], f_auto, atol=1e-4 * np.abs(f_auto).mean()
    )
