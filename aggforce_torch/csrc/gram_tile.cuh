// The 64x64 output-tile routine shared by the featurized Gram kernels
// (site_grams.cu, site_grams_tiled.cu).
//
// A block of kThreads threads owns one tile of a symmetric Gram
// sum_{t,a} row(t,a)^T col(t,a). For each chunk of kFrames frames two
// functions of the caller write the tile's row slice and column slice of the
// design rows
// (kRows = 3 * kFrames rows: x, y, z of each frame) into shared memory; the
// block then accumulates their outer products in fp32 registers, a 4x4
// micro-tile per thread. The frame sum is taken in two levels: each chunk's
// 48 products in fp32, the chunk sums in fp64 (16 additions per thread per
// chunk, against 768 FMAs). A single fp32 running sum over 30,000 design rows
// differed from the plain torch version by 9e-6 of the largest Gram entry on
// the card, and the fit magnifies Gram errors (see PERF.md).

#pragma once

#include <cuda_runtime.h>

#include <cstddef>

namespace gram_tile {

constexpr int kTile = 64;            // output tile edge
constexpr int kFrames = 16;          // frames per chunk
constexpr int kRows = 3 * kFrames;   // design rows per chunk (x, y, z)
constexpr int kThreads = 256;        // 16 x 16 threads
constexpr int kMicro = 4;            // micro-tile edge per thread

// total += sum over all frames of rows^T cols. build_rows(t0, dst) and
// build_cols(t0, dst) write frames [t0, t0 + kFrames) of the two slices into
// dst[a * kFrames + frame][column], zero outside the operands; with `same`
// the tile is on the diagonal and one slice serves as both.
template <class BuildRows, class BuildCols>
__device__ __forceinline__ void frame_sum(int n_frames, bool same,
                                          BuildRows build_rows,
                                          BuildCols build_cols,
                                          float (*rows)[kTile],
                                          float (*cols_buf)[kTile],
                                          double (&total)[kMicro][kMicro]) {
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const float(*cols)[kTile] = same ? rows : cols_buf;
  for (int t0 = 0; t0 < n_frames; t0 += kFrames) {
    build_rows(t0, rows);
    if (!same) build_cols(t0, cols_buf);
    __syncthreads();
    float acc[kMicro][kMicro] = {};
#pragma unroll 8
    for (int k = 0; k < kRows; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(&rows[k][ty * kMicro]);
      const float4 b = *reinterpret_cast<const float4*>(&cols[k][tx * kMicro]);
      const float av[kMicro] = {a.x, a.y, a.z, a.w};
      const float bv[kMicro] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int r = 0; r < kMicro; ++r) {
#pragma unroll
        for (int q = 0; q < kMicro; ++q) {
          acc[r][q] = fmaf(av[r], bv[q], acc[r][q]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kMicro; ++r) {
#pragma unroll
      for (int q = 0; q < kMicro; ++q) total[r][q] += acc[r][q];
    }
    __syncthreads();
  }
}

// Writes the tile at rows [i0, i0 + kTile), columns [j0, j0 + kTile) of the
// row-major (n, n) matrix `o`, clipped to n (the ragged edge); with `mirror`
// also its transpose at (j0, i0).
__device__ __forceinline__ void store_tile(const double (&total)[kMicro][kMicro],
                                           float* __restrict__ o, int n,
                                           int i0, int j0, bool mirror) {
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
#pragma unroll
  for (int r = 0; r < kMicro; ++r) {
    const int i = i0 + ty * kMicro + r;
#pragma unroll
    for (int q = 0; q < kMicro; ++q) {
      const int j = j0 + tx * kMicro + q;
      if (i < n && j < n) {
        const float v = static_cast<float>(total[r][q]);
        o[static_cast<size_t>(i) * n + j] = v;
        if (mirror) o[static_cast<size_t>(j) * n + i] = v;
      }
    }
  }
}

}  // namespace gram_tile
