"""Port parity: the per-site Gram (pack, plain twin, unpack) against the JAX
package's Pallas kernel, run in interpret mode on the CPU, and its oracle."""

import ctypes
import re
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


@pytest.mark.parametrize("case", CASES)
def test_float64_gram_sums_the_float32_rows_in_float64(case):
    """out_dtype float64 is the Gram of the float32 design rows with every
    product and sum in float64 (the CV's fold Grams); float32 stays the
    float32 sum."""
    _, p, mask, k = _packed(case)
    gpos, cg, fg, cf, kc = p
    args = (gpos, cg, fg, torch.as_tensor(mask), cf, kc, k, WIDTH, CLIP)
    got = pgram.site_grams(*args, out_dtype=torch.float64)
    rows = pgram.design_rows(*args[:6], k, 1.0 / WIDTH, CLIP)
    assert rows.dtype == torch.float32 and got.dtype == torch.float64
    expect = torch.matmul(rows.double().transpose(1, 2), rows.double())
    torch.testing.assert_close(got, expect, rtol=1e-13, atol=1e-13 * float(expect.abs().max()))
    assert torch.equal(got, got.transpose(1, 2))
    assert pgram.site_grams(*args).dtype == torch.float32


def test_wrapper_rejects_other_out_dtypes():
    _, p, mask, k = _packed(CASES[0])
    gpos, cg, fg, cf, kc = p
    with pytest.raises(ValueError, match="out_dtype"):
        pgram.site_grams(
            gpos, cg, fg, torch.as_tensor(mask), cf, kc, k, WIDTH, CLIP,
            out_dtype=torch.float16,
        )


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
    assert set(_build.SOURCES) == {
        "site_grams.cu", "site_grams_tiled.cu", "pair_moments.cu", "gb_apply.cu"
    }
    for src, symbol in (
        ("pair_moments.cu", "aggforce_pair_moments("), ("gb_apply.cu", "aggforce_gb_apply(")
    ):
        text = (_build.CSRC / src).read_text()
        assert f'extern "C" int {symbol}' in text
        assert "#include \"gram_tc.cuh\"" not in text
    headers = {h.name for h in _build.CSRC.glob("*.cuh")}
    assert headers == {"gram_tc.cuh"}
    for src, symbol in (
        ("site_grams.cu", "aggforce_site_grams("), ("site_grams_tiled.cu", "aggforce_site_grams_tiled(")
    ):
        text = (_build.CSRC / src).read_text()
        assert '#include "gram_tc.cuh"' in text
        assert f'extern "C" int {symbol}' in text
    header = (_build.CSRC / "gram_tc.cuh").read_text()
    assert "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32" in header
    assert "cp.async.bulk.tensor.2d" in header  # operand panels arrive by TMA


@pytest.mark.parametrize(
    "name, value",
    [
        ("kTile", pgram.PRODUCT_TILE),
        ("kFrameBlock", pgram.FRAME_BLOCK),
        ("kBadWorkspace", pgram._BAD_WORKSPACE),
    ],
)
def test_wrapper_constants_match_the_kernel_header(name, value):
    """The wrapper sizes the workspace with the header's tile and frame block
    (the C entry refuses any other layout with kBadWorkspace)."""
    text = (_build.CSRC / "gram_tc.cuh").read_text()
    assert re.search(rf"constexpr int {name} = {value};", text)


@pytest.mark.parametrize("tiled", [False, True])
def test_argtypes_match_the_c_entry(tiled):
    """The ctypes argument list is the C entry's parameter list, type by
    type: pointers, ints (sizes and the workspace layout), floats."""
    source, symbol = pgram._ENTRIES[tiled]
    text = (_build.CSRC / source).read_text()
    params = re.search(rf'extern "C" int {symbol}\(([^)]*)\)', text).group(1)
    kinds = []
    for param in params.split(","):
        decl = param.strip()
        if "*" in decl:
            kinds.append(ctypes.c_void_p)
        elif decl.startswith("int "):
            kinds.append(ctypes.c_int)
        elif decl.startswith("float "):
            kinds.append(ctypes.c_float)
        else:
            raise AssertionError(f"unexpected parameter {decl!r}")
    assert kinds == pgram._ARGTYPES
    assert "int tc, int k_alloc" in " ".join(params.split())


def test_float64_argtypes_match_the_c_entry():
    """The float64 entry's ctypes argument list is its C parameter list:
    the operands, the float64 output and the scratch (no running tiles),
    the sizes and the chunk layout, the row constants, the stream."""
    source, symbol = pgram._F64_ENTRY
    text = (_build.CSRC / source).read_text()
    params = re.search(rf'extern "C" int {symbol}\(([^)]*)\)', text).group(1)
    decls = [" ".join(x.split()) for x in params.split(",")]
    kinds = [
        ctypes.c_void_p if "*" in d else ctypes.c_int if d.startswith("int ") else ctypes.c_float
        for d in decls
    ]
    assert kinds == pgram._F64_ARGTYPES
    assert "double* out" in decls and "int tc" in decls and "int k_alloc" in decls


def test_stage_times_needs_the_card():
    _, p, mask, k = _packed(CASES[0])
    gpos, cg, fg, cf, kc = p
    with pytest.raises(ValueError, match="CUDA"):
        pgram.stage_times(False, gpos, cg, fg, torch.as_tensor(mask), cf, kc, k, WIDTH, CLIP)


# ---- the tensor-core kernels' host logic and numerics, modelled on the CPU --


@pytest.mark.parametrize(
    "t, s, k_pad, expect",
    [
        (10_000, 10, 1280, 1024),  # config #3: full chunks
        (20_000, 6, 9088, 1024),  # sweep block: 670 MB of scratch
        (16, 1, 32, 32),  # short T: one frame block
        (333, 2, 1280, 352),  # ragged T rounds up to the frame block
        (20_000, 66, 9088, 128),  # all 66 sweep sites: the byte budget binds
        (5, 10_000, 100_000, 32),  # never below one frame block
    ],
)
def test_frame_chunk_sizing(t, s, k_pad, expect):
    tc = pgram.frame_chunk(t, s, k_pad)
    assert tc == expect
    assert tc % pgram.FRAME_BLOCK == 0
    chunk, scratch, running = pgram.workspace_shapes(t, s, k_pad)
    assert chunk == tc and scratch[2] == 3 * tc
    assert scratch[1] % pgram.PRODUCT_TILE == 0 and scratch[1] - k_pad < pgram.PRODUCT_TILE
    if tc >= pgram.MAX_FRAME_CHUNK or expect > pgram.FRAME_BLOCK:
        assert 4 * scratch[0] * scratch[1] * scratch[2] <= pgram.SCRATCH_BYTES
    n_tiles = scratch[1] // pgram.PRODUCT_TILE
    assert running[1] == (n_tiles * (n_tiles + 1) // 2 if t > tc else 0)


def _tf32(x):
    """Round float32 to TF32 as ``cvt.rna.tf32.f32`` does: to the nearest
    10-bit mantissa, ties away from zero (bit masking)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _rz32(x):
    """float64 to float32, rounded toward zero (as the tensor core sums)."""
    y = x.float()
    over = y.double().abs() > x.abs()
    return torch.where(over, torch.nextafter(y, torch.zeros_like(y)), y)


def _tensor_core_gram(rows, chunk_rows, passes, fresh=True, stage_rows=32):
    """The kernels' numerics. Operands are TF32 (``passes`` = 3: the split
    lo*hi + hi*lo + hi*hi; 1: hi*hi only). Every tensor-core product of 8
    rows sums into its fp32 input and truncates. With ``fresh`` (the
    kernels) the products of each ``stage_rows``-row pipeline stage start
    from zero and join the chunk's fp32 sum by a rounded add; without, the
    truncating accumulator carries the whole chunk. Chunks of ``chunk_rows``
    rows are summed in float64."""
    k = rows.shape[2]
    total = torch.zeros(rows.shape[0], k, k, dtype=torch.float64)
    for chunk in rows.split(chunk_rows, dim=1):
        hi = _tf32(chunk).double()
        lo = _tf32(chunk - _tf32(chunk)).double()
        acc = torch.zeros(rows.shape[0], k, k)
        for s0 in range(0, chunk.shape[1], stage_rows):
            part = torch.zeros_like(acc) if fresh else acc
            for r0 in range(s0, min(s0 + stage_rows, chunk.shape[1]), 8):
                h, lo8 = hi[:, r0:r0 + 8], lo[:, r0:r0 + 8]
                steps = [h.transpose(1, 2) @ h]
                if passes == 3:
                    steps = [lo8.transpose(1, 2) @ h, h.transpose(1, 2) @ lo8] + steps
                for step in steps:
                    part = _rz32(part.double() + step)
            acc = acc + part if fresh else part
        total += acc.double()
    return total


def _config3_rows(n_frames):
    """Design rows of two config-#3 sites (175 atoms, 30 pairs, n_basis 7,
    K_pad 1,280) on a short synthetic trajectory, as the main path packs them."""
    from aggforce_torch import LinearMap
    from aggforce_torch.qp.fusedfeat import GBFeatSpec as TSpec, group_factorization
    from aggforce_torch.utils.synth import synthesize_trajectory

    base = np.random.default_rng(0).normal(scale=0.5, size=(175, 3))
    groups = [frozenset((i, i + 1)) for i in range(0, 60, 2)]
    cmap = LinearMap([[i] for i in range(0, 175, 18)], n_fg_sites=175)
    coords, forces = synthesize_trajectory(base, groups, n_frames, seed=2024)
    spec = TSpec(outer=8.0, n_basis=7, width=1.0)
    geom = {k: torch.as_tensor(v) for k, v in group_factorization(cmap, spec, set(groups)).items()}
    mask = torch.ones(n_frames)
    gpos, cg, fg, cf, kc = pgram.pack_operands(
        torch.as_tensor(coords), torch.as_tensor(forces), mask,
        torch.as_tensor(cmap.standard_matrix[:2], dtype=torch.float32),
        geom["group_mean"], geom["onehot"], geom["counts"], 0.6955215, 7,
        geom["centers"],
    )
    return pgram.design_rows(gpos, cg, fg, mask, cf, kc, 7, 1.0 / WIDTH, CLIP)


@pytest.mark.parametrize(
    "passes, fresh, within",
    [(3, True, True), (1, True, False), (3, False, False)],
    ids=["split, stage products (the kernels)", "one TF32 pass", "split, truncating chunk sums"],
)
def test_tensor_core_numerics_model(passes, fresh, within):
    """A torch model of the kernels' arithmetic, not the kernels: 3xTF32 with
    each 32-row stage's products summed in the tensor core, rounded fp32
    sums of the stages over the kernels' chunk length, and fp64 totals lies
    within 1e-6 of the largest entry of a float64 sum (chip_smoke.py's
    GRAM_REL_LIMIT). A single TF32 pass does not, and neither does the split
    when the tensor core's truncating accumulator carries the chunk, so the
    bound discriminates. The kernels themselves are held to the same limit
    on the card by chip_smoke.py."""
    n_frames = 120
    rows = _config3_rows(n_frames)[:1]
    assert rows.shape == (1, 3 * n_frames, 1280)
    exact = rows.double().transpose(1, 2) @ rows.double()
    chunk_rows = 3 * pgram.frame_chunk(n_frames, 1, 1280)
    assert chunk_rows == 3 * 128
    # the model's 32-row stage is the product stage's kDepth
    assert "constexpr int kDepth = 32;" in (_build.CSRC / "gram_tc.cuh").read_text()
    err = float((_tensor_core_gram(rows, chunk_rows, passes, fresh) - exact).abs().max())
    rel = err / float(exact.abs().max())
    assert (rel <= 1e-6) is within, rel


def test_tf32_rounding_model():
    x = torch.tensor([1.0, 1.0 + 2**-11, 1.0 + 3 * 2**-12, -(1.0 + 2**-11), 3.0e-3])
    hi = _tf32(x)
    # a tie rounds away from zero; 1 + 3*2^-12 rounds up to 1 + 2^-10
    assert hi.tolist()[:4] == [1.0, 1.0 + 2**-10, 1.0 + 2**-10, -(1.0 + 2**-10)]
    lo = _tf32(x - hi)
    np.testing.assert_array_equal((hi.double() + lo.double()).numpy(), x.double().numpy())


def _store_model(square, g_pad, n_basis):
    """A numpy model of the kernels' two stores: what FlatStore
    (csrc/site_grams.cu) and PairStore (csrc/site_grams_tiled.cu) write from
    the product tiles of a flat (S, K_pad, K_pad) square, by their index
    formulas: every element i <= j of every upper-triangle 128x128 tile over
    k_alloc, clipped to K_pad. Unwritten entries stay NaN."""
    s, k_pad, _ = square.shape
    n_tiles = -(-k_pad // pgram.PRODUCT_TILE)
    b = 1 + n_basis
    n_pairs = b * (b + 1) // 2
    flat = np.full(square.shape, np.nan, np.float32)
    pairs = np.full((s, n_pairs, g_pad, g_pad), np.nan, np.float32)
    edge = np.arange(pgram.PRODUCT_TILE)
    for ti in range(n_tiles):
        for tj in range(ti, n_tiles):
            i, j = np.meshgrid(ti * pgram.PRODUCT_TILE + edge, tj * pgram.PRODUCT_TILE + edge,
                               indexing="ij")
            keep = (i <= j) & (j < k_pad)
            i, j = i[keep], j[keep]
            v = square[:, i, j]
            flat[:, i, j] = v
            flat[:, j, i] = v
            bi, bj = i // g_pad, j // g_pad
            x, y = i - bi * g_pad, j - bj * g_pad
            p = bi * b - bi * (bi - 1) // 2 + (bj - bi)
            pairs[:, p, x, y] = v
            d = bi == bj
            pairs[:, p[d], y[d], x[d]] = v[:, d]
    return flat, pairs


@pytest.mark.parametrize("g, k, s", [(5, 4, 3), (17, 3, 1), (16, 1, 2), (145, 7, 1)])
def test_store_model_maps_tiles_onto_both_contracts(g, k, s):
    """The pair store's index map over 128-tiles that cross the ragged G_pad
    block edges rebuilds site_grams_tiled_plain's tiles exactly and covers
    every entry; the flat store gives the symmetric square, whose pairs
    mirror_tiles reassembles. This holds the index formulas, copied into
    ``_store_model``; the CUDA stores themselves are held to the plain
    versions on the card by chip_smoke.py's edge shapes (G_pad 16 to 1,136,
    n_basis 1 to 7)."""
    arrays, centers, k = _raw(3, t=16, s=s, g=g, k=k)
    coords, forces, mask, cmap, group_mean, onehot, counts = map(torch.as_tensor, arrays)
    gpos, cg, fg, cf, kc = pgram.pack_operands(
        coords, forces, mask, cmap, group_mean, onehot, counts, 0.7, k,
        torch.as_tensor(centers),
    )
    g_pad = gpos.shape[2]
    args = (gpos, cg, fg, mask)
    square = pgram.site_grams_plain(*args, cf, kc, k, WIDTH, CLIP)
    tiles = pgram.site_grams_tiled_plain(
        *args, cf[::g_pad].contiguous(), kc[:g_pad].contiguous(), k, WIDTH, CLIP
    )
    upper = torch.triu(square)
    sym = (upper + torch.triu(square, 1).transpose(1, 2)).numpy()
    flat, pairs = _store_model(square.numpy(), g_pad, k)
    assert not np.isnan(flat).any() and not np.isnan(pairs).any()
    np.testing.assert_array_equal(flat, sym)
    scale = float(tiles.abs().max()) + 1.0
    np.testing.assert_allclose(pairs, tiles.numpy(), atol=3e-5 * scale)
    np.testing.assert_array_equal(pgram.mirror_tiles(torch.as_tensor(pairs), k).numpy(), sym)
