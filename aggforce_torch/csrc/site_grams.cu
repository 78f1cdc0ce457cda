// Per-site featurized Gram of the force-map fit, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_gram_kernel` of the JAX package
// (its ops/pallas_gram.py:36-100, launched by `pallas_site_grams`).
// For every cg site s it computes the (K_pad, K_pad) float32 Gram
//
//     P_s = sum_{t,a} row(t,a)^T row(t,a)
//
// of the design rows of frame t and Cartesian component a, built from the
// raw group positions (the row formula is in gram_tc.cuh). Its per-column
// parameters are flat: center and kbt*count of column G_pad + j are
// centers[j] and kcounts[j], j = k*G_pad + g.
//
// What bounds it on this card: tensor-core operations. At the main path's
// size (T = 10,000 frames, S = 10 sites, K_pad = 1,280) the upper triangle
// of the Grams is about 4.9e11 FLOP against about 0.1 GB of operands and
// result. In 3xTF32 that is three TF32 products each, about 3.0 ms at the
// published 495 TFLOP/s TF32 rate (7.3 ms at the 67 TFLOP/s fp32 rate of the
// CUDA cores, the route of the kernel before it).
//
// What the design does about it (gram_tc.cuh): as the TPU kernel does, it
// computes each (frame, group) distance once and expands it into basis
// columns, then hands whole rows to the matrix units. A build stage writes
// the rows of a chunk of frames once into a K-major scratch; a product stage
// runs the upper-triangle 128x128 tiles of rows^T rows on the tensor cores
// (TMA loads, wgmma TF32 with a hi/lo split, fp32 stage and chunk sums,
// fp64 totals). This file's store writes each tile element i <= j and its
// mirror into the flat square, so the output is exactly symmetric.
//
// A second entry, aggforce_site_grams_f64, takes the same rows to a float64
// Gram whose every product is exact and every sum rounded to nearest in
// fp64: the Gram of the float32 rows, for callers whose solve amplifies the
// Gram's error by the conditioning of an under-regularized system (the cross
// validation's small l2 values). The tensor cores sum in fp32 with
// truncation and the hi/lo split drops lo*lo, both of which pull a positive
// sum low: the 3xTF32 Gram's diagonal reads ~2.4e-7 low at config #4's fold
// shapes, a negative ridge of ~6 against an l2 of 10 there. Its product
// stage runs on the CUDA cores' fp64 FMA (about 34 TFLOP/s on an H100 SXM,
// against 165 for 3xTF32), on the build stage's scratch: a block of 256
// threads per (upper-triangle 128x128 tile, site), each thread an 8x8
// register tile of fp64 sums, 8 design rows a step through shared memory
// (converted to fp64 once as they are stored), the next step's loads in
// flight while the current one is summed: 16.9 TFLOP/s on an H100 (S 10,
// K_pad 1,280, one 1,024-frame chunk, row build included), 3.4x the 3xTF32
// entry's time. Every chunk's block adds its sums into the output tile it
// owns, so no running workspace is needed and the result is the same from
// run to run.

#include "gram_tc.cuh"

namespace {

// Element (i, j), i <= j, of site s into the row-major (S, K_pad, K_pad)
// square, with its mirror.
struct FlatStore {
  float* out;
  int k_pad;
  __device__ __forceinline__ void operator()(int s, int i, int j, float v) const {
    if (i > j || j >= k_pad) return;
    float* o = out + static_cast<size_t>(s) * k_pad * k_pad;
    o[static_cast<size_t>(i) * k_pad + j] = v;
    if (i != j) o[static_cast<size_t>(j) * k_pad + i] = v;
  }
};

constexpr int kF64Depth = 8;     // design rows per step of the fp64 product
constexpr int kF64Threads = 256;  // 16 x 16 threads, each an 8x8 tile

// One chunk's fp64 Gram tile (ti, tj), ti <= tj, of site blockIdx.y, added
// into out (S, k_pad, k_pad) float64 (written when `first`); with `last` the
// totals are also mirrored below the diagonal. Thread (tx, ty) owns tile
// rows ty + 16i and columns tx + 16j, so a warp reads two rows of a_s (a
// broadcast) and 16 consecutive doubles of b_s per step.
__global__ void __launch_bounds__(kF64Threads, 1)
    site_grams_product_f64(const float* __restrict__ scratch, double* __restrict__ out,
                           int n_tiles, int k_alloc, int k_pad, int depth, int first,
                           int last) {
  constexpr int kTile = gram_tc::kTile;
  __shared__ double a_s[kF64Depth][kTile];
  __shared__ double b_s[kF64Depth][kTile];
  int ti = 0;
  int rem = blockIdx.x;
  while (rem >= n_tiles - ti) {
    rem -= n_tiles - ti;
    ++ti;
  }
  const int tj = ti + rem;
  const int s = blockIdx.y;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  // loads: thread -> column lc of both panels, rows lr .. lr + 3 of a step
  const int lc = threadIdx.x >> 1;
  const int lr = (threadIdx.x & 1) * 4;
  const float* col_a =
      scratch + (static_cast<size_t>(s) * k_alloc + ti * kTile + lc) * depth + lr;
  const float* col_b =
      scratch + (static_cast<size_t>(s) * k_alloc + tj * kTile + lc) * depth + lr;
  double acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0;
  float4 va = *reinterpret_cast<const float4*>(col_a);
  float4 vb = *reinterpret_cast<const float4*>(col_b);
  for (int k0 = 0; k0 < depth; k0 += kF64Depth) {
    __syncthreads();  // the previous step's reads are done
    a_s[lr][lc] = va.x;
    a_s[lr + 1][lc] = va.y;
    a_s[lr + 2][lc] = va.z;
    a_s[lr + 3][lc] = va.w;
    b_s[lr][lc] = vb.x;
    b_s[lr + 1][lc] = vb.y;
    b_s[lr + 2][lc] = vb.z;
    b_s[lr + 3][lc] = vb.w;
    __syncthreads();
    if (k0 + kF64Depth < depth) {
      va = *reinterpret_cast<const float4*>(col_a + k0 + kF64Depth);
      vb = *reinterpret_cast<const float4*>(col_b + k0 + kF64Depth);
    }
#pragma unroll
    for (int kk = 0; kk < kF64Depth; ++kk) {
      double a[8], b[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = a_s[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 8; ++j) b[j] = b_s[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fma(a[i], b[j], acc[i][j]);
    }
  }
  double* o = out + static_cast<size_t>(s) * k_pad * k_pad;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = ti * kTile + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = tj * kTile + tx + 16 * j;
      if (row > col || col >= k_pad) continue;
      double* at = o + static_cast<size_t>(row) * k_pad + col;
      const double v = first ? acc[i][j] : *at + acc[i][j];
      *at = v;
      if (last && row != col) o[static_cast<size_t>(col) * k_pad + row] = v;
    }
  }
}

}  // namespace

// Launches the kernels on `stream` and returns the first cudaError_t (0 when
// every launch was accepted), or gram_tc::kBadWorkspace. gpos, fg
// (3, T, G_pad), cg (S, 3, T), mask (T,), centers and kcounts
// (G_pad * n_basis,) are device pointers to contiguous float32 arrays; out is
// (S, K_pad, K_pad), K_pad = G_pad * (1 + n_basis). scratch and running are
// the caller's workspace, of the layout that tc, k_alloc and n_running state
// (see gram_tc::run_gram); stage_ms is null or a host array of two floats
// for the stage times.
extern "C" int aggforce_site_grams(const float* gpos, const float* cg,
                                   const float* fg, const float* mask,
                                   const float* centers, const float* kcounts,
                                   float* out, float* scratch, double* running,
                                   int n_sites, int n_frames, int g_pad,
                                   int n_basis, int tc, int k_alloc,
                                   int n_running, float inv_w, float dscale,
                                   float clip, float* stage_ms, void* stream) {
  const int k_pad = g_pad * (1 + n_basis);
  gram_tc::Operands p{gpos,    cg,      fg,     mask,     centers, kcounts,
                      g_pad,   1,       g_pad,  1,        n_sites, n_frames,
                      g_pad,   n_basis, inv_w,  dscale,   clip};
  return gram_tc::run_gram(p, FlatStore{out, k_pad}, scratch, running, tc,
                           k_alloc, n_running, stage_ms,
                           static_cast<cudaStream_t>(stream));
}

// The float64 Gram: as aggforce_site_grams, with out (S, K_pad, K_pad)
// float64 and no running tiles (each chunk adds into out). Returns the first
// cudaError_t, or gram_tc::kBadWorkspace when tc and k_alloc are not the
// build stage's layout.
extern "C" int aggforce_site_grams_f64(const float* gpos, const float* cg,
                                       const float* fg, const float* mask,
                                       const float* centers, const float* kcounts,
                                       double* out, float* scratch, int n_sites,
                                       int n_frames, int g_pad, int n_basis, int tc,
                                       int k_alloc, float inv_w, float dscale,
                                       float clip, void* stream) {
  using namespace gram_tc;
  const int k_pad = g_pad * (1 + n_basis);
  const int n_tiles = (k_pad + kTile - 1) / kTile;
  const int n_upper = n_tiles * (n_tiles + 1) / 2;
  if (tc <= 0 || tc % kFrameBlock != 0 || k_alloc != n_tiles * kTile)
    return kBadWorkspace;
  if (n_sites <= 0 || n_upper <= 0) return static_cast<int>(cudaSuccess);
  Operands p{gpos,    cg,      fg,     mask,     centers, kcounts,
             g_pad,   1,       g_pad,  1,        n_sites, n_frames,
             g_pad,   n_basis, inv_w,  dscale,   clip};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_chunks = n_frames > tc ? (n_frames + tc - 1) / tc : 1;
  const dim3 build_grid(tc / kFrameBlock, (g_pad + kGroupBlock - 1) / kGroupBlock);
  const dim3 build_block(kFrameBlock, 8);
  const dim3 grid(n_upper, n_sites);
  cudaError_t err = cudaSuccess;
  for (int c = 0; c < n_chunks && err == cudaSuccess; ++c) {
    site_grams_build<<<build_grid, build_block, 0, st>>>(p, scratch, c * tc, tc, k_alloc);
    site_grams_product_f64<<<grid, kF64Threads, 0, st>>>(
        scratch, out, n_tiles, k_alloc, k_pad, 3 * tc, c == 0, c + 1 == n_chunks);
    err = cudaGetLastError();
  }
  return static_cast<int>(err);
}
