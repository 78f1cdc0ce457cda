r"""Fused featurized design-row construction + per-site Gram.

Counterpart of the JAX package's ``ops/pallas_gram.py``. The hot op of the
featurized force-map fit is, per cg site s,

    P_s = sum_{t,a} row(t,a)^T row(t,a),
    row(t,a) = [ Fg[t,:,a] | Fg[t,g,a]*gz[t,s,g,k] + dph[t,s,g,k]*u[t,s,g,a] ]

with gz the Gaussian basis of the group<->site distance, dph its scaled
radial derivative (the divergence factor), and u the unit displacement.
:func:`site_grams` runs it as the hand-written CUDA kernel
``csrc/site_grams.cu``, which builds the rows from the raw group positions
on chip, a chunk of frames at a time, into a workspace, and takes their Gram
on the tensor cores (``csrc/gram_tc.cuh``); :func:`site_grams_plain` is the
same arithmetic in plain torch, the CPU path and the kernel's oracle.

At sweep scale (K_pad ~ 9,000) :func:`site_grams_tiled` computes the same
Grams one (G_pad, G_pad) basis-block pair at a time with the second
hand-written kernel ``csrc/site_grams_tiled.cu``; its plain twin is
:func:`site_grams_tiled_plain`.

Layout contract (as in the JAX package): feature index f in [0, G_pad) is
the one-hot id block; f = G_pad + k*G_pad + g is basis function k of group g
(k-major). Padded groups carry zero Fg and zero counts so their columns
vanish; :func:`unpack_gram` permutes the valid block into the canonical
g-major (f = g*K + k) layout of :mod:`aggforce_torch.qp.fusedfeat`.
"""

import ctypes
import functools
from typing import Tuple

import torch

from ..utils.debug import check_finite
from ..utils.device import full_fp32

_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 + [ctypes.c_float] * 3 + [
    ctypes.c_void_p
] * 2
# what the C entries return when the workspace they are given is not their
# layout (gram_tc::kBadWorkspace)
_BAD_WORKSPACE = -1
_ENTRIES = {
    False: ("site_grams.cu", "aggforce_site_grams"),
    True: ("site_grams_tiled.cu", "aggforce_site_grams_tiled"),
}

# the product stage's output tile edge (kTile of csrc/gram_tc.cuh) and the
# build stage's frame block (kFrameBlock), the unit of a frame chunk
PRODUCT_TILE = 128
FRAME_BLOCK = 32
# the longest frame chunk: 3 * 1,024 design rows summed in fp32 before the
# fp64 total, and the bytes the K-major row scratch may take
MAX_FRAME_CHUNK = 1024
SCRATCH_BYTES = 1 << 30


@functools.lru_cache(maxsize=None)
def _kernel(source: str, symbol: str):
    """The C entry ``symbol`` of the library built from ``csrc/<source>``."""
    from . import _build

    fn = getattr(_build.load(source), symbol)
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def frame_chunk(n_frames: int, n_sites: int, k_pad: int) -> int:
    """Frames per chunk of the kernels' row build: a multiple of
    ``FRAME_BLOCK``, at most ``MAX_FRAME_CHUNK``, no longer than T needs, and
    small enough that the (S, k_alloc, 3 * chunk) float32 scratch stays
    within ``SCRATCH_BYTES`` (one frame block at the least)."""
    k_alloc = -(-k_pad // PRODUCT_TILE) * PRODUCT_TILE
    fit = SCRATCH_BYTES // (4 * 3 * max(n_sites, 1) * max(k_alloc, 1))
    chunk = min(MAX_FRAME_CHUNK, -(-max(n_frames, 1) // FRAME_BLOCK) * FRAME_BLOCK, fit)
    return max(FRAME_BLOCK, chunk // FRAME_BLOCK * FRAME_BLOCK)


def workspace_shapes(n_frames: int, n_sites: int, k_pad: int):
    """(frame chunk, row scratch shape, fp64 running-tile shape) of one
    kernel launch. The scratch is (S, k_alloc, 3 * chunk), k_alloc = K_pad
    rounded up to the product tile; the running totals hold every
    upper-triangle tile of every site, and are empty when one chunk covers T.
    """
    tc = frame_chunk(n_frames, n_sites, k_pad)
    n_tiles = -(-k_pad // PRODUCT_TILE)
    n_upper = n_tiles * (n_tiles + 1) // 2 if n_frames > tc else 0
    return (
        tc,
        (n_sites, n_tiles * PRODUCT_TILE, 3 * tc),
        (n_sites, n_upper, PRODUCT_TILE * PRODUCT_TILE),
    )


def _launch(tiled, gpos, cg, fg, mask, centers, kcounts, n_basis, width, clip, stage_ms=None):
    """Launch a Gram kernel (the tiled one if ``tiled``) on the operands'
    current stream and return its output, with its workspace allocated here
    (zeroed scratch: its columns past K_pad are read as zeros and never
    written) and its layout passed along for the C entry to check.
    ``stage_ms``, a ctypes array of two floats, receives the stage times."""
    s_dim, t, g_pad = cg.shape[0], gpos.shape[1], gpos.shape[2]
    k_pad = g_pad * (1 + n_basis)
    if tiled:
        out_shape = (s_dim, len(block_pairs(n_basis)), g_pad, g_pad)
    else:
        out_shape = (s_dim, k_pad, k_pad)
    out = torch.empty(out_shape, dtype=torch.float32, device=gpos.device)
    tc, scratch_shape, running_shape = workspace_shapes(t, s_dim, k_pad)
    scratch = torch.zeros(scratch_shape, dtype=torch.float32, device=gpos.device)
    running = torch.empty(running_shape, dtype=torch.float64, device=gpos.device)
    source, symbol = _ENTRIES[tiled]
    with torch.cuda.device(gpos.device):
        stream = torch.cuda.current_stream(gpos.device).cuda_stream
        err = _kernel(source, symbol)(
            gpos.data_ptr(), cg.data_ptr(), fg.data_ptr(), mask.data_ptr(),
            centers.data_ptr(), kcounts.data_ptr(), out.data_ptr(),
            scratch.data_ptr(), running.data_ptr(), s_dim, t, g_pad, n_basis,
            tc, scratch_shape[1], running_shape[1], 1.0 / width, -2.0 / width,
            clip, stage_ms, stream,
        )
    if err == _BAD_WORKSPACE:
        raise RuntimeError(
            f"{symbol} refused the workspace: workspace_shapes and csrc/gram_tc.cuh "
            f"disagree on its layout (chunk {tc}, scratch {scratch_shape}, "
            f"running {running_shape})"
        )
    if err != 0:
        raise RuntimeError(f"{symbol} kernel launch failed (cudaError {err})")
    return out


def stage_times(tiled: bool, *args) -> Tuple[float, float]:
    """Device milliseconds of one Gram kernel launch's (build, product)
    stages, each summed over the launch's frame chunks, from CUDA events
    that the C entry records between its launches; waits for the launch.
    ``args`` are those of :func:`site_grams_tiled_blocks` (``tiled``) or
    :func:`site_grams`, on the card. A timing probe, not a use of the
    kernel: it adds nothing to the wrappers' ``launches``."""
    if args[0].device.type != "cuda":
        raise ValueError(f"stage_times needs CUDA tensors, not {args[0].device}")
    ms = (ctypes.c_float * 2)()
    _launch(tiled, *args, stage_ms=ms)
    return ms[0], ms[1]


@full_fp32()
def pack_operands(
    coords: torch.Tensor,  # (T, N, 3)
    forces: torch.Tensor,  # (T, N, 3)
    mask: torch.Tensor,  # (T,)
    cmap_mat: torch.Tensor,  # (S, N)
    group_mean: torch.Tensor,  # (G, N)
    onehot: torch.Tensor,  # (N, G)
    counts: torch.Tensor,  # (G,)
    kbt,
    n_basis: int,
    centers: torch.Tensor,  # (K,)
) -> Tuple[torch.Tensor, ...]:
    """Group positions/forces + padded flat per-column params.

    Returns (gpos, cg, fg_masked, centers_flat, kbt_counts_flat) in
    component-major layout — (3, T, G_pad) / (S, 3, T) — with the group axis
    zero-padded to a multiple of 16 (padded columns vanish because both fg
    and counts are zero there). Its einsums run at full float32 precision
    whatever the process's TF32 setting, as the JAX twin's
    ``precision="highest"``.
    """
    g = group_mean.shape[0]
    g_pad = max(16, -(-g // 16) * 16)
    pad = g_pad - g
    gpos = torch.einsum("gj,tjd->dtg", group_mean, coords)
    cg = torch.einsum("sj,tjd->sdt", cmap_mat, coords).contiguous()
    fg = torch.einsum("tja,jg->atg", forces, onehot)
    fg = fg * mask[None, :, None]
    gpos = torch.nn.functional.pad(gpos, (0, pad)).contiguous()
    fg = torch.nn.functional.pad(fg, (0, pad)).contiguous()
    # k-major flat layout: column k*G_pad + g
    centers_flat = torch.repeat_interleave(centers, g_pad)
    kbt_counts_flat = torch.nn.functional.pad(kbt * counts, (0, pad)).repeat(
        n_basis
    )
    return gpos, cg, fg, centers_flat, kbt_counts_flat


def _check_operands(gpos, cg, fg, mask, **params):
    """Raise unless the operands meet the Gram kernels' common contract.

    ``params`` are the per-column (or per-basis, per-group) parameter
    vectors by name, with the shape each must have in ``(name, shape)``
    pairs; the caller derives those shapes from G_pad and n_basis.
    """
    ops = {"gpos": gpos, "cg": cg, "fg": fg, "mask": mask}
    ops.update({name: x for name, (x, _) in params.items()})
    device = gpos.device
    for name, x in ops.items():
        if not isinstance(x, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor")
        if x.device != device:
            raise ValueError(f"{name} is on {x.device}, gpos on {device}")
        if x.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if gpos.ndim != 3 or gpos.shape[0] != 3:
        raise ValueError(f"gpos must be (3, T, G_pad), got {tuple(gpos.shape)}")
    _, t, g_pad = gpos.shape
    if g_pad % 16 != 0:
        raise ValueError(f"G_pad must be a multiple of 16, got {g_pad}")
    if fg.shape != gpos.shape:
        raise ValueError(f"fg must match gpos {tuple(gpos.shape)}")
    if cg.ndim != 3 or cg.shape[1:] != (3, t):
        raise ValueError(f"cg must be (S, 3, {t}), got {tuple(cg.shape)}")
    if mask.shape != (t,):
        raise ValueError(f"mask must be ({t},), got {tuple(mask.shape)}")
    for name, (x, shape) in params.items():
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(x.shape)}")


def site_grams(
    gpos: torch.Tensor,  # (3, T, G_pad) — component-major
    cg: torch.Tensor,  # (S, 3, T) — site-major
    fg: torch.Tensor,  # (3, T, G_pad) — mask folded in by caller
    mask: torch.Tensor,  # (T,)
    centers_flat: torch.Tensor,  # (GK_pad,)
    kbt_counts_flat: torch.Tensor,  # (GK_pad,)
    n_basis: int,
    width: float,
    clip: float,
) -> torch.Tensor:
    """All-site featurized Grams: returns (S, K_pad, K_pad) float32.

    CUDA tensors go to the hand-written kernel (``csrc/site_grams.cu``),
    built on first use; each launch adds one to ``site_grams.launches``, and
    in debug mode (``utils.debug``) its output is checked for NaN. CPU
    tensors go to :func:`site_grams_plain`. Any T is taken; G_pad must be a
    multiple of 16, and every operand float32, contiguous and on one device.
    """
    gk = (gpos.shape[-1] * n_basis,)
    _check_operands(
        gpos, cg, fg, mask, centers_flat=(centers_flat, gk),
        kbt_counts_flat=(kbt_counts_flat, gk),
    )
    args = (gpos, cg, fg, mask, centers_flat, kbt_counts_flat, n_basis, width, clip)
    if gpos.device.type == "cpu":
        return site_grams_plain(*args)
    if gpos.device.type != "cuda":
        raise ValueError(f"site_grams runs on CUDA or CPU, not {gpos.device}")
    out = _launch(False, *args)
    site_grams.launches += 1
    # the kernel bypasses torch's dispatch, so debug mode checks it here
    check_finite("site_grams", out)
    return out


site_grams.launches = 0


def site_grams_plain(
    gpos: torch.Tensor,
    cg: torch.Tensor,
    fg: torch.Tensor,
    mask: torch.Tensor,
    centers_flat: torch.Tensor,
    kbt_counts_flat: torch.Tensor,
    n_basis: int,
    width: float,
    clip: float,
    t_chunk: int = 1024,
) -> torch.Tensor:
    """Plain-torch twin of the kernel (same layout and arithmetic).

    A torch version of the JAX package's ``reference_site_grams``, in the
    operands' dtype and chunked over ``t_chunk`` frames so the materialized
    (S, 3*t_chunk, K_pad) rows stay bounded.
    """
    _, t, g_pad = gpos.shape
    s_dim = cg.shape[0]
    k_pad = g_pad * (1 + n_basis)
    inv_w = 1.0 / width
    out = torch.zeros((s_dim, k_pad, k_pad), dtype=gpos.dtype, device=gpos.device)
    for lo in range(0, t, t_chunk):
        hi = min(t, lo + t_chunk)
        rows = design_rows(
            gpos[:, lo:hi], cg[:, :, lo:hi], fg[:, lo:hi], mask[lo:hi],
            centers_flat, kbt_counts_flat, n_basis, inv_w, clip,
        )
        out += torch.matmul(rows.transpose(1, 2), rows)
    return out


def design_rows(gpos, cg, fg, mask, centers_flat, kbt_counts_flat, n_basis, inv_w, clip):
    """Materialized design rows (S, 3*T, K_pad) of a frame range.

    Row a*T + t holds component a of frame t. The plain twin builds it one
    frame chunk at a time; the kernels build the same rows, transposed
    (K-major), into their workspace.
    """
    disp = gpos[None] - cg[..., None]  # (S, 3, t, G_pad)
    d = torch.sqrt(disp[:, 0] * disp[:, 0] + disp[:, 1] * disp[:, 1] + disp[:, 2] * disp[:, 2])
    inv_d = 1.0 / torch.clamp(d, min=1e-30)
    drep = d.repeat(1, 1, n_basis)  # (S, t, GK_pad), k-major
    offset = (drep - centers_flat) * inv_w
    raw = torch.exp(-(offset * offset))
    gz = torch.clamp(raw, min=clip) - clip
    live = (raw > clip).to(raw.dtype)
    dph = kbt_counts_flat * live * raw * (-2.0 * inv_w) * offset * mask[:, None]
    comps = []
    for a in range(3):
        fg_a = fg[a].expand(disp.shape[0], -1, -1)  # (S, t, G_pad)
        u_a = disp[:, a] * inv_d
        row_gb = fg_a.repeat(1, 1, n_basis) * gz + dph * u_a.repeat(1, 1, n_basis)
        comps.append(torch.cat([fg_a, row_gb], dim=2))  # (S, t, K_pad)
    return torch.cat(comps, dim=1)


def block_pairs(n_basis: int):
    """The tile contract's pair axis: basis-block pairs (bi <= bj) of the
    B = 1 + n_basis blocks, numbered row by row."""
    b = 1 + n_basis
    return [(i, j) for i in range(b) for j in range(i, b)]


def site_grams_tiled_blocks(
    gpos: torch.Tensor,  # (3, T, G_pad) — component-major
    cg: torch.Tensor,  # (S, 3, T) — site-major
    fg: torch.Tensor,  # (3, T, G_pad) — mask folded in by caller
    mask: torch.Tensor,  # (T,)
    centers: torch.Tensor,  # (n_basis,) raw basis centers
    kbt_counts: torch.Tensor,  # (G_pad,) kbt * group size
    n_basis: int,
    width: float,
    clip: float,
) -> torch.Tensor:
    """Basis-block-pair Gram tiles: returns (S, n_pairs, G_pad, G_pad) float32.

    Tile p = (bi, bj) of :func:`block_pairs` is sum_{t,a} row_bi^T row_bj,
    where block 0 of a design row is the id columns and block b >= 1 basis
    center b - 1. CUDA tensors go to the hand-written kernel
    (``csrc/site_grams_tiled.cu``), built on first use; each launch adds one
    to ``site_grams_tiled.launches``. CPU tensors go to
    :func:`site_grams_tiled_plain`. Any T is taken; G_pad must be a multiple
    of 16, and every operand float32, contiguous and on one device.
    """
    _check_operands(
        gpos, cg, fg, mask, centers=(centers, (n_basis,)),
        kbt_counts=(kbt_counts, (gpos.shape[-1],)),
    )
    args = (gpos, cg, fg, mask, centers, kbt_counts, n_basis, width, clip)
    if gpos.device.type == "cpu":
        return site_grams_tiled_plain(*args)
    if gpos.device.type != "cuda":
        raise ValueError(f"site_grams_tiled runs on CUDA or CPU, not {gpos.device}")
    out = _launch(True, *args)
    site_grams_tiled.launches += 1
    check_finite("site_grams_tiled", out)
    return out


def site_grams_tiled(
    gpos: torch.Tensor,
    cg: torch.Tensor,
    fg: torch.Tensor,
    mask: torch.Tensor,
    centers: torch.Tensor,
    kbt_counts: torch.Tensor,
    n_basis: int,
    width: float,
    clip: float,
) -> torch.Tensor:
    """Sweep-scale per-site Grams, Gram-tiled: returns (S, K_pad, K_pad).

    The contract of the JAX package's ``pallas_site_grams_tiled``: the same
    Grams as :func:`site_grams` in the same k-major layout, but computed one
    (G_pad, G_pad) upper-triangle basis-block pair at a time
    (:func:`site_grams_tiled_blocks`), so no K_pad-wide row or accumulator
    exists and K_pad ~ 9,000 runs. ``centers`` are the raw (n_basis,)
    centers and ``kbt_counts`` the (G_pad,) per-group weights, neither
    flat-tiled. The JAX version's ``t_block`` is gone: it sized TPU VMEM
    windows, and the CUDA kernel masks the ragged frame edge itself, so any
    T is taken and nothing is padded.
    """
    return mirror_tiles(
        site_grams_tiled_blocks(
            gpos, cg, fg, mask, centers, kbt_counts, n_basis, width, clip
        ),
        n_basis,
    )


site_grams_tiled.launches = 0


def site_grams_tiled_plain(
    gpos: torch.Tensor,
    cg: torch.Tensor,
    fg: torch.Tensor,
    mask: torch.Tensor,
    centers: torch.Tensor,
    kbt_counts: torch.Tensor,
    n_basis: int,
    width: float,
    clip: float,
    t_chunk: int = 1024,
) -> torch.Tensor:
    """Plain-torch twin of the tiled kernel: the same (S, n_pairs, G_pad,
    G_pad) tiles from materialized (S, 3*t_chunk, G_pad) block rows
    (:func:`block_rows`), one frame chunk at a time, in the operands' dtype."""
    _, t, g_pad = gpos.shape
    pairs = block_pairs(n_basis)
    out = torch.zeros(
        (cg.shape[0], len(pairs), g_pad, g_pad), dtype=gpos.dtype, device=gpos.device
    )
    for lo in range(0, t, t_chunk):
        hi = min(t, lo + t_chunk)
        rows = block_rows(
            gpos[:, lo:hi], cg[:, :, lo:hi], fg[:, lo:hi], mask[lo:hi], centers,
            kbt_counts, n_basis, 1.0 / width, clip,
        )
        for p, (i, j) in enumerate(pairs):
            out[:, p] += torch.matmul(rows[i].transpose(1, 2), rows[j])
    return out


def block_rows(gpos, cg, fg, mask, centers, kbt_counts, n_basis, inv_w, clip):
    """Materialized design rows of a frame range, one (S, 3*t, G_pad) tensor
    per basis block (block 0 the id columns). Row a*t + frame holds
    component a of that frame."""
    s_dim, g_pad = cg.shape[0], gpos.shape[2]
    disp = gpos[None] - cg[..., None]  # (S, 3, t, G_pad)
    d = torch.sqrt(disp[:, 0] * disp[:, 0] + disp[:, 1] * disp[:, 1] + disp[:, 2] * disp[:, 2])
    u = disp * (1.0 / torch.clamp(d, min=1e-30))[:, None]
    fg_s = fg.expand(s_dim, -1, -1, -1)
    rows = [fg_s.reshape(s_dim, -1, g_pad)]
    for k in range(n_basis):
        offset = (d - centers[k]) * inv_w
        raw = torch.exp(-(offset * offset))
        gz = torch.clamp(raw, min=clip) - clip
        live = (raw > clip).to(raw.dtype)
        dph = kbt_counts * live * raw * (-2.0 * inv_w) * offset * mask[:, None]
        rows.append((fg_s * gz[:, None] + dph[:, None] * u).reshape(s_dim, -1, g_pad))
    return rows


def mirror_tiles(tiles: torch.Tensor, n_basis: int) -> torch.Tensor:
    """Reassemble (S, n_pairs, G_pad, G_pad) tiles into the flat k-major
    (S, K_pad, K_pad) square that :func:`unpack_gram` reads.

    Block pair (bj, bi) below the diagonal is the transpose of its upper
    twin. The JAX version does this with one gather and a ``where``; here it
    is one strided copy per block, the same data movement into one output.
    """
    s, _, g_pad, _ = tiles.shape
    b = 1 + n_basis
    full = tiles.new_empty((s, b, g_pad, b, g_pad))
    for p, (i, j) in enumerate(block_pairs(n_basis)):
        full[:, i, :, j] = tiles[:, p]
        if i != j:
            full[:, j, :, i] = tiles[:, p].transpose(1, 2)
    return full.reshape(s, b * g_pad, b * g_pad)


def unpack_gram(gram_pad: torch.Tensor, g: int, n_basis: int) -> torch.Tensor:
    """Extract + permute the valid block into the canonical g-major layout.

    Kernel column for basis k of group gi sits at G_pad + k*G_pad + gi; the
    canonical fused layout expects g + gi*n_basis + k. Written as
    reshape/slice/transpose/concat (blocked data movement), not as a fancy
    index, exactly as the JAX twin.
    """
    s = gram_pad.shape[0]
    n = gram_pad.shape[-1]
    g_pad = n // (1 + n_basis)

    def permute_cols(x):  # reorder the LAST axis; x (s, r, n) -> (s, r, m)
        r = x.shape[1]
        blocks = x.reshape(s, r, 1 + n_basis, g_pad)[..., :g]
        id_cols = blocks[:, :, 0, :]  # (s, r, g)
        basis = blocks[:, :, 1:, :].transpose(2, 3)  # (s, r, g, n_basis)
        return torch.cat([id_cols, basis.reshape(s, r, g * n_basis)], dim=-1)

    cols = permute_cols(gram_pad)  # (s, n, m)
    rows = permute_cols(cols.transpose(1, 2))  # (s, m, m)
    return rows.transpose(1, 2).contiguous()
