// Moments of every site pair's distance fluctuation over all frames, for
// constraint detection (constraints/finder.py), for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package's finder is XLA. It was added
// because the plain torch version (`_distance_sd`) runs 154 chunks of 64
// frames with about 13 small kernels each at the 175-site system's 10,000
// frames: 2,021 launches and 9.9 ms of device time a detection, with the
// host's launches idling the card for about 20 ms more.
//
// For every pair (i, j), i a site of `other` and j a site of `xyz`, it forms
//
//     d[t] = |other[t,i] - xyz[t,j]|,   delta[t] = d[t] - d[0],
//     s1 = sum_t delta[t],   s2 = sum_t delta[t]^2,
//     sd = sqrt(max(s2/T - (s1/T)^2, 0)),
//
// and writes sd and the mask sd < threshold (false on the diagonal within
// one system). The distances are those of the plain version: elementwise
// coordinate differences summed over x, y, z in fp32 (no matmul), an IEEE
// square root, the fluctuation against frame 0 in fp32. Each delta is added
// to fp64 sums, which is wider than the plain version's fp32 sums.
//
// What bounds it on this card: at 10,000 frames x 175 sites it reads 21 MB
// of coordinates (6 us at 3.35 TB/s) and does about 10 flops for each of the
// 1.5e8 (frame, pair) items of the upper triangle (0.02 ms at 67 TFLOP/s
// fp32). Both are far below the plain version's launches and its passes over
// (chunk, N, N) blocks in device memory.
//
// What the design does about it: one launch over all frames, nothing but the
// moments in device memory.
// - A block owns a 32 x 32 tile of pairs; within one system only tiles on or
//   above the diagonal (the mirror is exact: (a - b)^2 == (b - a)^2).
// - It walks its frames a group of kGroup at a time, staging the group's
//   coordinates of its two 32-site ranges in shared memory as float4 (one
//   16-byte shared load per site). The global reads are coalesced 4-byte
//   loads, one coordinate per thread for every frame of the group: a frame's
//   3n floats start 16-byte aligned only when n % 4 == 0.
// - Each of 256 threads keeps d0, s1 and s2 of four pairs in registers; a
//   warp shares the `other` site (a broadcast) across 32 `xyz` sites.
// - The entry splits the frames into F slices (a grid axis) so that the
//   grid holds about eight blocks per SM (aggforce_pair_moments_slices reads
//   the card's SM count; five blocks are resident at once at 48 registers a
//   thread): at 175 sites 21 tiles take F = 51 on 132 SMs, at 1,500 sites
//   the 1,128 tiles alone fill the card and F = 1. Each slice's sums go to
//   the caller's workspace (F, n_b, n_a) of (s1, s2) pairs, and the finalize
//   launch adds the F partials in slice order, with no atomics, so the
//   result is the same bits run to run. It also forms sd, applies the
//   threshold, mirrors the upper triangle within one system and clears the
//   diagonal. sd goes back into the workspace (each pair's s1 of slice 0,
//   read before it is overwritten), so the outputs add 1 byte a pair (the
//   mask) to the workspace's 16 F.
// - What is left (PERF.md): about 26 instructions an item, each IEEE square
//   root in a branch of its own around its rare slow path, so a thread's four
//   roots do not overlap; 0.29-0.31 ms at 10,000 x 175 against the 0.02 ms
//   bound.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kTile = 32;                        // sites per tile edge
constexpr int kThreads = 256;                    // threads per moments block
constexpr int kRows = kTile * kTile / kThreads;  // pairs per thread (4)
constexpr int kRowStep = kThreads / kTile;       // warps per block (8)
constexpr int kGroup = 32;                       // frames staged at a time
constexpr int kFinalizeThreads = 256;
constexpr int kBlocksPerSm = 8;  // grid blocks per SM the frame split aims for
constexpr int kMaxSlices = 65535;  // the grid's y dimension
constexpr int kBadArgs = -1;       // the entry's return for arguments it refuses

// Stage frames [t0, t0 + nf) of sites [i0, i0 + 32) of `other` into
// s[f][0..31] and of sites [j0, j0 + 32) of `xyz` into s[f][32..63]; sites
// past the end are zero (their pairs are never stored). Thread e < 192 owns
// one coordinate (side, site, k) and copies it for every frame, so a frame's
// 96 floats of each range are read by 96 neighbouring threads.
__device__ __forceinline__ void stage(float4 (*s)[2 * kTile], const float* other,
                                      const float* xyz, int n_b, int n_a, long long t0,
                                      int nf, int i0, int j0) {
  const int e = threadIdx.x;
  if (e >= 2 * kTile * 3) return;
  const int side = e >= kTile * 3;
  const int q = e - side * kTile * 3;
  const int site = q / 3;
  const int n = side ? n_a : n_b;
  const int g = (side ? j0 : i0) + site;
  float* dst = reinterpret_cast<float*>(&s[0][side * kTile + site]) + (q - site * 3);
  constexpr int kFrameFloats = 2 * kTile * 4;  // floats between frames in s
  if (g >= n) {
    for (int f = 0; f < nf; ++f) dst[f * kFrameFloats] = 0.0f;
    return;
  }
  const float* src = (side ? xyz : other) + (t0 * n + g) * 3 + (q - site * 3);
  const long long stride = 3LL * n;
#pragma unroll 8
  for (int f = 0; f < nf; ++f) dst[f * kFrameFloats] = __ldg(src + f * stride);
}

// fp32 distance as the plain version takes it: x, then y, then z.
__device__ __forceinline__ float dist(float4 a, float4 b) {
  const float dx = __fsub_rn(b.x, a.x);
  const float dy = __fsub_rn(b.y, a.y);
  const float dz = __fsub_rn(b.z, a.z);
  float dsq = __fmul_rn(dx, dx);
  dsq = __fmaf_rn(dy, dy, dsq);
  dsq = __fmaf_rn(dz, dz, dsq);
  return __fsqrt_rn(dsq);
}

// Grid (tiles, F): block (u, f) sums the frames of slice f for tile u into
// part[f] as (s1, s2) pairs, laid out (F, n_b, n_a).
__global__ void __launch_bounds__(kThreads)
pair_moments_partial(const float* __restrict__ xyz, const float* __restrict__ other,
                     int n_frames, int n_a, int n_b, int within, double2* __restrict__ part) {
  __shared__ float4 s[kGroup][2 * kTile];
  // tile u -> (row tile ti over `other`, column tile tj over `xyz`)
  const int nt_a = (n_a + kTile - 1) / kTile;
  int ti = 0, tj = blockIdx.x;
  if (within) {
    while (tj >= nt_a - ti) {  // row ti holds the tiles tj = ti .. nt_a - 1
      tj -= nt_a - ti;
      ++ti;
    }
    tj += ti;
  } else {
    ti = blockIdx.x / nt_a;
    tj = blockIdx.x - ti * nt_a;
  }
  const int i0 = ti * kTile, j0 = tj * kTile;
  const int tx = threadIdx.x % kTile;  // column (xyz site) in the tile
  const int ty = threadIdx.x / kTile;  // first row (other site) in the tile

  stage(s, other, xyz, n_b, n_a, 0, 1, i0, j0);
  __syncthreads();
  float d0[kRows];
  double s1[kRows], s2[kRows];
  {
    const float4 a = s[0][kTile + tx];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      d0[r] = dist(a, s[0][ty + r * kRowStep]);
      s1[r] = 0.0;
      s2[r] = 0.0;
    }
  }
  __syncthreads();

  const long long n_slices = gridDim.y;
  const long long lo = n_frames * static_cast<long long>(blockIdx.y) / n_slices;
  const long long hi = n_frames * static_cast<long long>(blockIdx.y + 1) / n_slices;
  for (long long t0 = lo; t0 < hi; t0 += kGroup) {
    const int nf = static_cast<int>(hi - t0 < kGroup ? hi - t0 : kGroup);
    stage(s, other, xyz, n_b, n_a, t0, nf, i0, j0);
    __syncthreads();
#pragma unroll 4
    for (int f = 0; f < nf; ++f) {
      const float4 a = s[f][kTile + tx];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const double delta = __fsub_rn(dist(a, s[f][ty + r * kRowStep]), d0[r]);
        s1[r] += delta;
        s2[r] = fma(delta, delta, s2[r]);
      }
    }
    __syncthreads();
  }

  const int j = j0 + tx;
  if (j >= n_a) return;
  double2* out = part + static_cast<size_t>(blockIdx.y) * n_b * n_a;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int i = i0 + ty + r * kRowStep;
    if (i < n_b) out[static_cast<size_t>(i) * n_a + j] = make_double2(s1[r], s2[r]);
  }
}

// One thread per output pair: the F partials summed in slice order. sd is
// written over the pair's s1 of slice 0, which only this thread reads.
// Within one system the thread of an upper pair (i <= j) also writes the
// mirror (j, i), whose partials nobody reads, and lower threads return.
__global__ void __launch_bounds__(kFinalizeThreads)
pair_moments_finalize(double2* __restrict__ part, int n_slices, int n_frames, int n_a,
                      int n_b, int within, double threshold, bool* __restrict__ mask) {
  const long long idx = static_cast<long long>(blockIdx.x) * kFinalizeThreads + threadIdx.x;
  if (idx >= static_cast<long long>(n_b) * n_a) return;
  const int i = static_cast<int>(idx / n_a);
  const int j = static_cast<int>(idx - static_cast<long long>(i) * n_a);
  if (within && i > j) return;
  const size_t plane = static_cast<size_t>(n_b) * n_a;
  double s1 = 0.0, s2 = 0.0;
  for (int f = 0; f < n_slices; ++f) {
    const double2 p = part[f * plane + idx];
    s1 += p.x;
    s2 += p.y;
  }
  const double mean = s1 / n_frames;
  const double v = sqrt(fmax(s2 / n_frames - mean * mean, 0.0));
  const bool hit = v < threshold && !(within && i == j);
  part[idx].x = v;
  mask[idx] = hit;
  if (within && i != j) {
    const size_t mirror = static_cast<size_t>(j) * n_a + i;
    part[mirror].x = v;
    mask[mirror] = hit;
  }
}

// Pair tiles of the moments grid, or 0 for sizes the kernels do not take.
long long pair_tiles(int n_frames, int n_a, int n_b, int within) {
  if (n_frames < 1 || n_a < 1 || n_b < 1 || (within && n_a != n_b)) return 0;
  const long long nt_a = (n_a + kTile - 1) / kTile;
  const long long nt_b = (n_b + kTile - 1) / kTile;
  const long long tiles = within ? nt_a * (nt_a + 1) / 2 : nt_a * nt_b;
  const long long pairs = static_cast<long long>(n_a) * n_b;
  const long long final_blocks = (pairs + kFinalizeThreads - 1) / kFinalizeThreads;
  return tiles > 0x7fffffffLL || final_blocks > 0x7fffffffLL ? 0 : tiles;
}

}  // namespace

// Frame slices F of a launch on the current device: enough that tiles x F
// gives about kBlocksPerSm blocks per SM, 1 when the tiles alone do, never
// more slices than frames. The caller's workspace holds F x n_b x n_a
// (s1, s2) double pairs. Returns F >= 1, 0 for sizes the kernels do not
// take, or minus the cudaError_t when the device cannot be read.
extern "C" int aggforce_pair_moments_slices(int n_frames, int n_a, int n_b, int within) {
  const long long tiles = pair_tiles(n_frames, n_a, n_b, within);
  if (tiles == 0) return 0;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return -static_cast<int>(err);
  long long f = (static_cast<long long>(kBlocksPerSm) * sms + tiles - 1) / tiles;
  if (f > n_frames) f = n_frames;
  if (f > kMaxSlices) f = kMaxSlices;
  return f < 1 ? 1 : static_cast<int>(f);
}

// Launches both kernels on `stream` and returns the first cudaError_t (0 when
// both launches were accepted), or kBadArgs (negative) for sizes it does not
// take. xyz (T, n_a, 3) and other (T, n_b, 3) are device pointers to
// contiguous float32 arrays; within one system (within != 0) other is xyz
// and n_b == n_a. part is the caller's (n_slices, n_b, n_a) workspace of
// (s1, s2) double pairs, n_slices from aggforce_pair_moments_slices; on
// return the s1 of slice 0 holds each pair's sd. mask (n_b, n_a) bool is
// the output.
extern "C" int aggforce_pair_moments(const float* xyz, const float* other, int n_frames,
                                     int n_a, int n_b, int within, int n_slices,
                                     double threshold, double2* part, bool* mask,
                                     void* stream) {
  const long long tiles = pair_tiles(n_frames, n_a, n_b, within);
  if (tiles == 0 || n_slices < 1 || n_slices > n_frames || n_slices > kMaxSlices) {
    return kBadArgs;
  }
  const long long pairs = static_cast<long long>(n_a) * n_b;
  const long long final_blocks = (pairs + kFinalizeThreads - 1) / kFinalizeThreads;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  pair_moments_partial<<<dim3(static_cast<unsigned>(tiles), n_slices), kThreads, 0, st>>>(
      xyz, other, n_frames, n_a, n_b, within, part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  pair_moments_finalize<<<static_cast<unsigned>(final_blocks), kFinalizeThreads, 0, st>>>(
      part, n_slices, n_frames, n_a, n_b, within, threshold, mask);
  return static_cast<int>(cudaGetLastError());
}
