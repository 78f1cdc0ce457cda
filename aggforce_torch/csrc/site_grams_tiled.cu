// Sweep-scale featurized Grams, one basis-block pair at a time, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel `_gram_tiled_kernel` of the JAX package
// (its ops/pallas_gram.py:313-392, launched by `pallas_site_grams_tiled`).
// In the k-major layout a design row is B = 1 + n_basis contiguous G_pad-wide
// blocks: block 0 is the id columns fg_a[t,g] (gz = 1, dph = 0); block
// b >= 1 is basis center b - 1,
//
//     fg_a[t,g]*gz + dph*u_a,    disp = gpos[:,t,g] - cg[s,:,t],
//     d = |disp|,  u = disp / max(d, 1e-30),  off = (d - center[b-1]) / w,
//     raw = exp(-off^2),  gz = max(raw, clip) - clip,
//     dph = kbt*count[g] * [raw > clip] * raw * (-2/w) * off * mask[t].
//
// For site s and upper-triangle block pair p = (bi <= bj) the kernel writes
// the (G_pad, G_pad) tile sum_{t,a} row_bi(t,a)^T row_bj(t,a) into
// out[s, p] of an (S, n_pairs, G_pad, G_pad) array, n_pairs = B(B+1)/2,
// pairs numbered row by row. The caller mirrors the strictly-lower pairs and
// reassembles the flat (S, K_pad, K_pad) square; no K_pad-wide row or
// accumulator exists anywhere, which is what lets K_pad ~ 9,000 run.
//
// What bounds it on this card: operations. At the sweep path's size
// (T = 20,000, G_pad = 1,136, n_basis = 7, 6 sites per launch) the unique
// Gram entries cost about 3.0e13 FLOP against about 1.7 GB of operands and
// result: about 0.44 s at the published 67 TFLOP/s fp32, 0.5 ms of memory
// time. The tiling re-reads the operands, though: every 64x64 output tile
// reads two 64-group slices of gpos and fg over all frames (about 61 MB at
// T = 20,000), about 10^4 tiles per site, mostly from L2.
//
// What the design does about it:
//  * The grid is its own, not the TPU's: (64x64 sub-tile of the G_pad
//    square, pair, site). Diagonal pairs compute only the upper sub-tiles and
//    write their mirror; off-diagonal pairs compute the whole square. No
//    frame split, no atomics: the result is the same from run to run.
//  * The TPU grid's sequential frame axis is a loop inside the block: for
//    each chunk of 16 frames the block builds its two slices (basis block bi
//    over the row groups, bj over the column groups) in shared memory from
//    the raw operands, one distance per (frame, group) element, then
//    accumulates outer products in fp32 registers with fp64 chunk sums
//    (gram_tile.cuh, shared with site_grams.cu). At T = 20,000 a tile sums
//    60,000 design rows, twice the first kernel's.
//  * The ragged G_pad edge (1,136 is not a multiple of 64) and the ragged
//    frame edge are masked here, so nothing is padded. Output offsets are
//    size_t: one launch writes 1.1 GB.

#include "gram_tile.cuh"

namespace {

using gram_tile::kFrames;
using gram_tile::kThreads;
using gram_tile::kTile;

struct TiledArgs {
  const float* gpos;     // (3, T, G_pad) group positions
  const float* cg;       // (S, 3, T) site positions
  const float* fg;       // (3, T, G_pad) group force sums, mask folded in
  const float* mask;     // (T,) frame validity
  const float* centers;  // (n_basis,) basis centers
  const float* kcounts;  // (G_pad,) kbt * group size
  int n_frames;
  int g_pad;
  float inv_w;   // 1 / width
  float dscale;  // -2 / width
  float clip;
};

// Rows of basis block b (0 = id) for frames [t0, t0 + kFrames) and groups
// [g0, g0 + kTile) of site `cg_s` into dst[a * kFrames + frame][group]; zero
// outside T and G_pad.
__device__ __forceinline__ void build_block_slice(const TiledArgs& p,
                                                  const float* __restrict__ cg_s,
                                                  int t0, int b, int g0,
                                                  float (*dst)[kTile]) {
  const size_t plane = static_cast<size_t>(p.n_frames) * p.g_pad;
  const float center = b > 0 ? p.centers[b - 1] : 0.0f;
  for (int e = threadIdx.x; e < kFrames * kTile; e += kThreads) {
    const int tt = e / kTile;
    const int cc = e - tt * kTile;
    const int t = t0 + tt;
    const int g = g0 + cc;
    float r0 = 0.0f, r1 = 0.0f, r2 = 0.0f;
    if (t < p.n_frames && g < p.g_pad) {
      const size_t tg = static_cast<size_t>(t) * p.g_pad + g;
      const float f0 = p.fg[tg];
      const float f1 = p.fg[plane + tg];
      const float f2 = p.fg[2 * plane + tg];
      if (b == 0) {
        r0 = f0;
        r1 = f1;
        r2 = f2;
      } else {
        const float x0 = p.gpos[tg] - cg_s[t];
        const float x1 = p.gpos[plane + tg] - cg_s[p.n_frames + t];
        const float x2 = p.gpos[2 * plane + tg] - cg_s[2 * p.n_frames + t];
        const float d = sqrtf(x0 * x0 + x1 * x1 + x2 * x2);
        const float inv_d = 1.0f / fmaxf(d, 1e-30f);
        const float off = (d - center) * p.inv_w;
        const float raw = expf(-(off * off));
        const float gz = fmaxf(raw, p.clip) - p.clip;
        const float live = raw > p.clip ? 1.0f : 0.0f;
        const float dph =
            p.kcounts[g] * live * raw * p.dscale * off * p.mask[t];
        r0 = f0 * gz + dph * (x0 * inv_d);
        r1 = f1 * gz + dph * (x1 * inv_d);
        r2 = f2 * gz + dph * (x2 * inv_d);
      }
    }
    dst[tt][cc] = r0;
    dst[kFrames + tt][cc] = r1;
    dst[2 * kFrames + tt][cc] = r2;
  }
}

__global__ void __launch_bounds__(kThreads)
    site_grams_tiled_kernel(TiledArgs p, float* __restrict__ out, int n_sub,
                            int n_blocks) {
  __shared__ __align__(16) float rows_i[gram_tile::kRows][kTile];
  __shared__ __align__(16) float rows_j[gram_tile::kRows][kTile];

  // blockIdx.y enumerates the upper-triangle block pairs (bi <= bj) row by
  // row, as the pair list of the tile contract does
  int bi = 0;
  int rem = blockIdx.y;
  while (rem >= n_blocks - bi) {
    rem -= n_blocks - bi;
    ++bi;
  }
  const int bj = bi + rem;
  const int ti = blockIdx.x / n_sub;
  const int tj = blockIdx.x - ti * n_sub;
  const bool diag_pair = bi == bj;
  if (diag_pair && ti > tj) return;  // written as the mirror of (tj, ti)
  const int s = blockIdx.z;
  const int n_pairs = n_blocks * (n_blocks + 1) / 2;
  const float* cg_s = p.cg + static_cast<size_t>(s) * 3 * p.n_frames;

  double total[gram_tile::kMicro][gram_tile::kMicro] = {};
  gram_tile::frame_sum(
      p.n_frames, diag_pair && ti == tj,
      [&](int t0, float (*dst)[kTile]) {
        build_block_slice(p, cg_s, t0, bi, ti * kTile, dst);
      },
      [&](int t0, float (*dst)[kTile]) {
        build_block_slice(p, cg_s, t0, bj, tj * kTile, dst);
      },
      rows_i, rows_j, total);
  float* o = out + (static_cast<size_t>(s) * n_pairs + blockIdx.y) *
                       static_cast<size_t>(p.g_pad) * p.g_pad;
  gram_tile::store_tile(total, o, p.g_pad, ti * kTile, tj * kTile,
                        diag_pair && ti != tj);
}

}  // namespace

// Launches the kernel on `stream` and returns cudaGetLastError() (0 when the
// launch was accepted). All pointers are device pointers to contiguous
// float32 arrays of the shapes listed in TiledArgs; out is
// (S, n_pairs, G_pad, G_pad) with n_pairs = B(B+1)/2, B = 1 + n_basis.
extern "C" int aggforce_site_grams_tiled(const float* gpos, const float* cg,
                                         const float* fg, const float* mask,
                                         const float* centers,
                                         const float* kcounts, float* out,
                                         int n_sites, int n_frames, int g_pad,
                                         int n_basis, float inv_w, float dscale,
                                         float clip, void* stream) {
  const int n_sub = (g_pad + kTile - 1) / kTile;
  const int n_blocks = 1 + n_basis;
  const int n_pairs = n_blocks * (n_blocks + 1) / 2;
  if (n_sites <= 0 || n_sub <= 0) return static_cast<int>(cudaSuccess);
  TiledArgs p{gpos,     cg,    fg,    mask,   centers, kcounts,
              n_frames, g_pad, inv_w, dscale, clip};
  dim3 grid(n_sub * n_sub, n_pairs, n_sites);
  site_grams_tiled_kernel<<<grid, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(p, out, n_sub,
                                                                 n_blocks);
  return static_cast<int>(cudaGetLastError());
}
