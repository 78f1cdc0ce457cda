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
