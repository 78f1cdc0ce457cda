// Per-site featurized Gram of the force-map fit, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_gram_kernel` of the JAX package
// (its ops/pallas_gram.py:36-100, launched by `pallas_site_grams`).
// For every cg site s it computes the (K_pad, K_pad) float32 Gram
//
//     P_s = sum_{t,a} row(t,a)^T row(t,a)
//
// of the design rows of frame t and Cartesian component a, built from the
// raw group positions. Column c = b*G_pad + g is, for the id block b = 0,
// fg_a[t,g]; for basis block b >= 1 (flat index j = c - G_pad),
//
//     fg_a[t,g]*gz + dph*u_a,    disp = gpos[:,t,g] - cg[s,:,t],
//     d = |disp|,  u = disp / max(d, 1e-30),  off = (d - center[j]) / w,
//     raw = exp(-off^2),  gz = max(raw, clip) - clip,
//     dph = kbt*count[j] * [raw > clip] * raw * (-2/w) * off * mask[t].
//
// fg carries the frame mask already, so the mask multiplies dph only.
//
// What bounds it on this card: operations. At the main path's size
// (T = 10,000 frames, S = 10 sites, K_pad = 1,280) the upper triangle of the
// Grams is about 5.2e11 FLOP against about 0.1 GB of operands and result, so
// the floor is the fp32 rate of the CUDA cores (about 7.7 ms at the
// published 67 TFLOP/s), not memory.
//
// What the design does about it:
//  * The TPU kernel keeps a site's whole K_pad^2 accumulator in VMEM (6.5 MB
//    at that size); an SM has 227 KB of shared memory, so the output is
//    tiled: one block per (upper-triangle 64x64 output tile, site), 2,100
//    blocks at that size, many times the 132 SMs. No frame split and no
//    atomics are needed, and the result is the same from run to run.
//  * CUDA blocks run in no order, so the TPU grid's sequential frame axis is
//    a loop inside the block (gram_tile.cuh): for each chunk of 16 frames
//    the block builds the tile's row slice and column slice of the design
//    rows, for all three components, in shared memory straight from the raw
//    operands (no design tensor reaches device memory), then accumulates
//    outer products in registers, with the chunk sums taken in fp64.
//    Diagonal tiles build one slice.
//  * Off-diagonal tiles write themselves and their transpose. The ragged
//    frame edge and the ragged column edge are masked here, so any T and
//    any K_pad are taken.

#include "gram_tile.cuh"

namespace {

using gram_tile::kFrames;
using gram_tile::kThreads;
using gram_tile::kTile;

struct GramArgs {
  const float* gpos;     // (3, T, G_pad) group positions
  const float* cg;       // (S, 3, T) site positions
  const float* fg;       // (3, T, G_pad) group force sums, mask folded in
  const float* mask;     // (T,) frame validity
  const float* centers;  // (G_pad * n_basis,) basis center of each column
  const float* kcounts;  // (G_pad * n_basis,) kbt * group size per column
  int n_frames;
  int g_pad;
  int k_pad;
  float inv_w;   // 1 / width
  float dscale;  // -2 / width
  float clip;
};

// Design rows of frames [t0, t0 + kFrames) and columns [c0, c0 + kTile) of
// site `cg_s` into dst[a * kFrames + frame][column]; zero outside T and K_pad.
__device__ __forceinline__ void build_slice(const GramArgs& p,
                                            const float* __restrict__ cg_s,
                                            int t0, int c0,
                                            float (*dst)[kTile]) {
  const size_t plane = static_cast<size_t>(p.n_frames) * p.g_pad;
  for (int e = threadIdx.x; e < kFrames * kTile; e += kThreads) {
    const int tt = e / kTile;
    const int cc = e - tt * kTile;
    const int t = t0 + tt;
    const int c = c0 + cc;
    float r0 = 0.0f, r1 = 0.0f, r2 = 0.0f;
    if (t < p.n_frames && c < p.k_pad) {
      const int b = c / p.g_pad;
      const size_t tg = static_cast<size_t>(t) * p.g_pad + (c - b * p.g_pad);
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
        const int j = c - p.g_pad;
        const float off = (d - p.centers[j]) * p.inv_w;
        const float raw = expf(-(off * off));
        const float gz = fmaxf(raw, p.clip) - p.clip;
        const float live = raw > p.clip ? 1.0f : 0.0f;
        const float dph =
            p.kcounts[j] * live * raw * p.dscale * off * p.mask[t];
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
    site_grams_kernel(GramArgs p, float* __restrict__ out, int n_tiles) {
  __shared__ __align__(16) float rows_i[gram_tile::kRows][kTile];
  __shared__ __align__(16) float rows_j[gram_tile::kRows][kTile];

  // blockIdx.x enumerates the upper-triangle tiles (ti <= tj) row by row
  int ti = 0;
  int rem = blockIdx.x;
  while (rem >= n_tiles - ti) {
    rem -= n_tiles - ti;
    ++ti;
  }
  const int tj = ti + rem;
  const bool diag = ti == tj;
  const int i0 = ti * kTile;
  const int j0 = tj * kTile;
  const int s = blockIdx.y;
  const float* cg_s = p.cg + static_cast<size_t>(s) * 3 * p.n_frames;

  double total[gram_tile::kMicro][gram_tile::kMicro] = {};
  gram_tile::frame_sum(
      p.n_frames, diag,
      [&](int t0, float (*dst)[kTile]) { build_slice(p, cg_s, t0, i0, dst); },
      [&](int t0, float (*dst)[kTile]) { build_slice(p, cg_s, t0, j0, dst); },
      rows_i, rows_j, total);
  gram_tile::store_tile(total, out + static_cast<size_t>(s) * p.k_pad * p.k_pad,
                        p.k_pad, i0, j0, !diag);
}

}  // namespace

// Launches the kernel on `stream` and returns cudaGetLastError() (0 when the
// launch was accepted). All pointers are device pointers to contiguous
// float32 arrays of the shapes listed in GramArgs; out is (S, K_pad, K_pad)
// with K_pad = G_pad * (1 + n_basis).
extern "C" int aggforce_site_grams(const float* gpos, const float* cg,
                                   const float* fg, const float* mask,
                                   const float* centers, const float* kcounts,
                                   float* out, int n_sites, int n_frames,
                                   int g_pad, int n_basis, float inv_w,
                                   float dscale, float clip, void* stream) {
  const int k_pad = g_pad * (1 + n_basis);
  const int n_tiles = (k_pad + kTile - 1) / kTile;
  const int n_pairs = n_tiles * (n_tiles + 1) / 2;
  if (n_sites <= 0 || n_pairs <= 0) return static_cast<int>(cudaSuccess);
  GramArgs p{gpos,     cg,    fg,    mask,   centers, kcounts,
             n_frames, g_pad, k_pad, inv_w,  dscale,  clip};
  dim3 grid(n_pairs, n_sites);
  site_grams_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      p, out, n_tiles);
  return static_cast<int>(cudaGetLastError());
}
