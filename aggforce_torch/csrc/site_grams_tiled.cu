// Sweep-scale featurized Grams, as basis-block pair tiles, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel `_gram_tiled_kernel` of the JAX package
// (its ops/pallas_gram.py:313-392, launched by `pallas_site_grams_tiled`).
// In the k-major layout a design row is B = 1 + n_basis contiguous G_pad-wide
// blocks: block 0 is the id columns fg_a[t,g]; block b >= 1 is basis center
// b - 1 with the per-group weight kbt*count[g] (the row formula is in
// gram_tc.cuh). For site s and upper-triangle block pair p = (bi <= bj) the
// output holds the (G_pad, G_pad) tile sum_{t,a} row_bi(t,a)^T row_bj(t,a)
// at out[s, p] of an (S, n_pairs, G_pad, G_pad) array, n_pairs = B(B+1)/2,
// pairs numbered row by row. The caller mirrors the strictly-lower pairs.
//
// What bounds it on this card: tensor-core operations. At the sweep path's
// size (T = 20,000, G_pad = 1,136, n_basis = 7, 6 sites per launch) the
// unique Gram entries cost about 3.0e13 FLOP against about 1.7 GB of
// operands and result; in 3xTF32 that is three TF32 products each, about
// 0.18 s at the published 495 TFLOP/s (0.44 s at 67 TFLOP/s fp32 on the CUDA
// cores, the route of the kernel before it).
//
// What the design does about it (gram_tc.cuh): the geometry of each
// (site, frame, group) is computed once per launch by a build stage into a
// K-major scratch of 1,024-frame chunks (670 MB at that size), and a product
// stage runs the upper-triangle 128x128 tiles of the flat K_pad square
// (K_pad = 9,088 = 71 * 128) on the tensor cores in 3xTF32, instead of
// rebuilding each slice for every 64x64 sub-tile and basis pair. The tiles
// ignore the G_pad block edges (1,136 is not a multiple of 128); this file's
// store maps every element i <= j to its pair (i / G_pad, j / G_pad), and a
// diagonal pair also gets the transpose. Offsets are size_t: one launch
// writes 1.1 GB.

#include "gram_tc.cuh"

namespace {

// Element (i, j), i <= j, of site s's flat square into its pair tile.
struct PairStore {
  float* out;
  int g_pad;
  int n_blocks;
  __device__ __forceinline__ void operator()(int s, int i, int j, float v) const {
    if (i > j || j >= g_pad * n_blocks) return;
    const int bi = i / g_pad;
    const int bj = j / g_pad;
    const int x = i - bi * g_pad;
    const int y = j - bj * g_pad;
    const int pair = bi * n_blocks - bi * (bi - 1) / 2 + (bj - bi);
    const int n_pairs = n_blocks * (n_blocks + 1) / 2;
    float* o = out + (static_cast<size_t>(s) * n_pairs + pair) *
                         static_cast<size_t>(g_pad) * g_pad;
    o[static_cast<size_t>(x) * g_pad + y] = v;
    if (bi == bj && x != y) o[static_cast<size_t>(y) * g_pad + x] = v;
  }
};

}  // namespace

// Launches the kernels on `stream` and returns the first cudaError_t (0 when
// every launch was accepted), or gram_tc::kBadWorkspace. gpos, fg
// (3, T, G_pad), cg (S, 3, T), mask (T,), centers (n_basis,) and kcounts
// (G_pad,) are device pointers to contiguous float32 arrays; out is
// (S, n_pairs, G_pad, G_pad) with n_pairs = B(B+1)/2, B = 1 + n_basis. The
// workspace and stage_ms are as for aggforce_site_grams.
extern "C" int aggforce_site_grams_tiled(const float* gpos, const float* cg,
                                         const float* fg, const float* mask,
                                         const float* centers,
                                         const float* kcounts, float* out,
                                         float* scratch, double* running,
                                         int n_sites, int n_frames, int g_pad,
                                         int n_basis, int tc, int k_alloc,
                                         int n_running, float inv_w,
                                         float dscale, float clip,
                                         float* stage_ms, void* stream) {
  const int n_blocks = 1 + n_basis;
  gram_tc::Operands p{gpos,    cg,      fg,    mask,     centers, kcounts,
                      1,       0,       0,     1,        n_sites, n_frames,
                      g_pad,   n_basis, inv_w, dscale,   clip};
  return gram_tc::run_gram(p, PairStore{out, g_pad, n_blocks}, scratch, running,
                           tc, k_alloc, n_running, stage_ms,
                           static_cast<cudaStream_t>(stream));
}
