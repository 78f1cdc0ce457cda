// Featurized force-map application (FusedGBMap, qp/fusedfeat.py), for
// Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package applies its fused map with XLA
// (aggforce_tpu/qp/fusedfeat.py:468). It replaces the plain torch version
// (`_fused_apply`), which writes (t, S, G, K) Gaussian, offset and
// derivative blocks and a (t, S, G, K, 3) divergence block to device memory
// and then spreads the group weights to atoms with a (t, S, N) one-hot
// einsum: at 66 sites, 1,125 groups and 7 basis functions each (t, S, G, K)
// block is 2.1 GB per 1,000 frames.
//
// For frame t, cg site s and group g (a constraint group or a loose atom),
// with gpos the group's mean position, cg the site's position, fg the sum of
// the group's member forces and count its size:
//
//     disp = gpos - cg,  d = |disp|,  u = disp / max(d, 1e-30),
//     off_k = (d - center_k) / width,  raw_k = exp(-off_k^2),
//     gz_k = max(raw_k, clip) - clip,
//     dphi_k = raw_k * (-2 off_k / width) where raw_k > clip, else 0,
//     out[t,s] = sum_g (c_id[s,g] + sum_k gz_k c[s,g,k]) fg[t,g]
//              + kbt sum_g count[g] (sum_k dphi_k c[s,g,k]) u.
//
// Every atom of a group has the group's weight, so sum_j w[t,s,j] f[t,j]
// equals sum_g w_g[t,s,g] fg[t,g] and no (t, S, N) weight is formed. The
// terms are the plain version's in the same order, with IEEE exponential,
// square root and division (no fast-math intrinsics) and NaN passed through
// as torch.clamp passes it.
//
// Precision: each exponential is the fp32 expf of -off^2 rounded to fp32,
// and everything else is fp64: the geometry from the fp32 coordinates, the
// offsets from the spec's float64 centers (qp.fusedfeat.exact_centers), the
// clip rule's test raw > clip (taken as off^2 < -ln(clip), the float64
// definition's decision), gz, dphi, the K-term and group sums. A
// fitted map's coefficients are large and cancel within a group and across
// groups, so the plain version's fp32 offsets and sums lose more digits
// than the exponentials do.
//
// What bounds it on this card: about t S G K exponentials and ten operations
// each. At 20,000 frames x 66 sites x 1,125 groups x 7 that is 1.04e10
// exponentials, about 3 ms at 67 TFLOP/s fp32 (2.5 ms of MUFU ex2 at 16 a
// clock per SM); the bytes are the coordinates and forces read once
// (0.36 GB, 0.1 ms at 3.35 TB/s) and (t, S, 3) written. The fp64 work is
// some seven operations a term at half the fp32 rate, and three conversions
// between fp32 and fp64 a term at 16 a clock per SM.
//
// What the design does about it: nothing of size t S G is written.
// - A prologue launch writes each group's mean position and summed force
//   as fp64 planes (G, 3, T), frame-minor: the members' fp32 values added in
//   ascending atom order (exact in fp64), the mean divided by the count,
//   through a shared-memory transpose, from the caller's CSR member lists.
// - The main launch gives a block 32 frames (a warp's lanes) x 8 sites (its
//   warps) and a slice of the groups. It stages 16 groups at a time: their
//   planes for the block's frames (coalesced rows) and the block's sites'
//   coefficients of those groups, which a warp reads as broadcasts. A
//   thread holds one (frame, site) pair and its six fp64 sums: per group
//   the geometry once, then K basis terms.
// - The entry splits the groups into P slices (a grid axis) so that the
//   grid holds about 16 blocks per SM (aggforce_gb_apply_slices reads the
//   card's SM count): P = 4 at 2,048 frames x 66 sites, 1 at 20,000. Each
//   slice's sums go to the caller's (P, S, 6, T) workspace, and the
//   finalize launch adds the slices in order and rounds W + kbt D once to
//   fp32, with no atomics, so a repeat is bitwise.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kFrames = 32;                    // frames per block (lanes)
constexpr int kSiteRows = 8;                   // sites per block (warps)
constexpr int kThreads = kFrames * kSiteRows;  // 256
constexpr int kChunk = 16;                     // groups staged at a time
constexpr int kPlanes = 6;                     // W x, y, z and D x, y, z sums
constexpr int kFinalizeThreads = 256;
constexpr int kBlocksPerSm = 16;   // grid blocks per SM the group split aims for
constexpr int kMaxSlices = 65535;  // the grid's y dimension
constexpr int kMaxBasis = 128;     // basis functions the shared memory holds
constexpr int kBadArgs = -1;       // the entry's return for arguments it refuses
constexpr double kMinDist = 1e-30;

struct Basis {
  double inv_width;       // 1 / width: offsets
  double neg2_inv_width;  // -2 / width: dphi's factor of the offset
  double clip;
  double live_off2;       // -ln(clip): raw > clip where off^2 < this
};

// Group planes: block (frame tile, group tile of 16) sums the members of
// its groups for its frames, threads over groups (neighbouring groups hold
// neighbouring atoms), then writes the tile frame-minor, lanes over frames.
__global__ void __launch_bounds__(kThreads)
gb_group_planes(const float* __restrict__ forces, const float* __restrict__ coords,
                const int* __restrict__ offsets, const int* __restrict__ atoms,
                const float* __restrict__ counts, int n_frames, int n_atoms, int n_groups,
                double* __restrict__ gpos, double* __restrict__ fg) {
  __shared__ double s[2][3][kChunk][kFrames + 1];
  const long long t0 = static_cast<long long>(blockIdx.x) * kFrames;
  const int g0 = blockIdx.y * kChunk;
  const int gi = threadIdx.x % kChunk;
  const int g = g0 + gi;
  int lo = 0, hi = 0;
  double count = 1.0;
  if (g < n_groups) {
    lo = offsets[g];
    hi = offsets[g + 1];
    count = fmax(static_cast<double>(counts[g]), 1.0);
  }
  for (int f = threadIdx.x / kChunk; f < kFrames; f += kThreads / kChunk) {
    double p[3] = {0.0, 0.0, 0.0};
    double q[3] = {0.0, 0.0, 0.0};
    const long long t = t0 + f;
    if (t < n_frames) {
      const float* x = coords + t * n_atoms * 3;
      const float* y = forces + t * n_atoms * 3;
      for (int m = lo; m < hi; ++m) {
        const long long j = 3LL * atoms[m];
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          p[c] = __dadd_rn(p[c], static_cast<double>(__ldg(x + j + c)));
          q[c] = __dadd_rn(q[c], static_cast<double>(__ldg(y + j + c)));
        }
      }
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      s[0][c][gi][f] = __ddiv_rn(p[c], count);
      s[1][c][gi][f] = q[c];
    }
  }
  __syncthreads();
  const int lane = threadIdx.x % 32;
  const long long t = t0 + lane;
  if (t >= n_frames) return;
  for (int r = threadIdx.x / 32; r < kChunk && g0 + r < n_groups; r += kSiteRows) {
    const long long at = static_cast<long long>(g0 + r) * 3 * n_frames + t;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      gpos[at + static_cast<long long>(c) * n_frames] = s[0][c][r][lane];
      fg[at + static_cast<long long>(c) * n_frames] = s[1][c][r][lane];
    }
  }
}

// Main launch. Grid (frame tiles x site blocks, P): block (u, p) sums the
// groups of slice p for frame tile u / site_blocks and site block
// u % site_blocks (the site blocks of one frame tile run side by side and
// share its planes in L2), into part (P, S, 6, T) as (W, D) sums.
__global__ void __launch_bounds__(kThreads)
gb_apply_partial(const double* __restrict__ gpos, const double* __restrict__ fg,
                 const float* __restrict__ cg, const float* __restrict__ coefs,
                 const float* __restrict__ counts, const double* __restrict__ centers,
                 int include_id, int n_frames, int n_sites, int n_groups, int n_basis,
                 Basis basis, double* __restrict__ part) {
  extern __shared__ double smem[];
  double* s_gpos = smem;                                  // [kChunk][3][kFrames]
  double* s_fg = s_gpos + kChunk * 3 * kFrames;           // [kChunk][3][kFrames]
  double* s_gb = s_fg + kChunk * 3 * kFrames;             // [kSiteRows][kChunk * n_basis]
  double* s_id = s_gb + kSiteRows * kChunk * n_basis;     // [kSiteRows][kChunk]
  double* s_counts = s_id + kSiteRows * kChunk;           // [kChunk]
  double* s_centers = s_counts + kChunk;                  // [n_basis]

  const int site_blocks = (n_sites + kSiteRows - 1) / kSiteRows;
  const int tile = blockIdx.x / site_blocks;
  const int s0 = (blockIdx.x - tile * site_blocks) * kSiteRows;
  const int lane = threadIdx.x % 32;
  const int row = threadIdx.x / 32;
  const long long t0 = static_cast<long long>(tile) * kFrames;
  const long long t = t0 + lane;
  const int s = s0 + row;
  const bool live = t < n_frames && s < n_sites;
  const int n_slices = gridDim.y;
  const int g_lo = static_cast<int>(static_cast<long long>(n_groups) * blockIdx.y / n_slices);
  const int g_hi = static_cast<int>(static_cast<long long>(n_groups) * (blockIdx.y + 1) / n_slices);
  const long long row_len = static_cast<long long>(n_groups) * (include_id + n_basis);
  const long long gb_off = include_id ? n_groups : 0;

  for (int k = threadIdx.x; k < n_basis; k += kThreads) s_centers[k] = centers[k];
  double cx = 0.0, cy = 0.0, cz = 0.0;
  if (live) {
    const float* c = cg + (t * n_sites + s) * 3;
    cx = c[0];
    cy = c[1];
    cz = c[2];
  }
  double w0 = 0.0, w1 = 0.0, w2 = 0.0, d0 = 0.0, d1 = 0.0, d2 = 0.0;

  for (int c0 = g_lo; c0 < g_hi; c0 += kChunk) {
    const int n = g_hi - c0 < kChunk ? g_hi - c0 : kChunk;
    __syncthreads();  // the previous stage's reads are done
    for (int e = threadIdx.x; e < n * 3 * kFrames; e += kThreads) {
      const long long tt = t0 + e % kFrames;
      const long long at = (static_cast<long long>(c0) * 3 + e / kFrames) * n_frames + tt;
      const bool in = tt < n_frames;
      s_gpos[e] = in ? __ldg(gpos + at) : 0.0;
      s_fg[e] = in ? __ldg(fg + at) : 0.0;
    }
    for (int e = threadIdx.x; e < kSiteRows * n * n_basis; e += kThreads) {
      const int r = e / (n * n_basis);
      const int q = e - r * n * n_basis;
      const int ss = s0 + r;
      s_gb[r * kChunk * n_basis + q] =
          ss < n_sites ? __ldg(coefs + ss * row_len + gb_off + static_cast<long long>(c0) * n_basis + q)
                       : 0.0f;
    }
    for (int e = threadIdx.x; e < kSiteRows * n; e += kThreads) {
      const int r = e / n;
      const int q = e - r * n;
      const int ss = s0 + r;
      s_id[r * kChunk + q] =
          include_id && ss < n_sites ? __ldg(coefs + ss * row_len + c0 + q) : 0.0f;
    }
    for (int e = threadIdx.x; e < n; e += kThreads) s_counts[e] = counts[c0 + e];
    __syncthreads();
    if (!live) continue;

    const double* gb = s_gb + row * kChunk * n_basis;
    for (int gi = 0; gi < n; ++gi) {
      const double* pg = s_gpos + gi * 3 * kFrames + lane;
      const double* pf = s_fg + gi * 3 * kFrames + lane;
      const double dx = __dsub_rn(pg[0], cx);
      const double dy = __dsub_rn(pg[kFrames], cy);
      const double dz = __dsub_rn(pg[2 * kFrames], cz);
      const double d = __dsqrt_rn(__fma_rn(dz, dz, __fma_rn(dy, dy, __dmul_rn(dx, dx))));
      const double* c = gb + gi * n_basis;
      double wg = 0.0, dv = 0.0;
#pragma unroll 8
      for (int k = 0; k < n_basis; ++k) {
        const double off = __dmul_rn(__dsub_rn(d, s_centers[k]), basis.inv_width);
        const double off2 = __dmul_rn(off, off);
        const double raw = expf(-__double2float_rn(off2));
        const double gz = __dsub_rn(raw < basis.clip ? basis.clip : raw, basis.clip);
        const double dphi =
            off2 < basis.live_off2 ? __dmul_rn(raw, __dmul_rn(off, basis.neg2_inv_width)) : 0.0;
        wg = __fma_rn(gz, c[k], wg);
        dv = __fma_rn(dphi, c[k], dv);
      }
      wg = __dadd_rn(wg, s_id[row * kChunk + gi]);
      const double dm = d < kMinDist ? kMinDist : d;  // NaN passes, as torch.clamp
      const double q = __ddiv_rn(__dmul_rn(s_counts[gi], dv), dm);
      w0 = __fma_rn(wg, pf[0], w0);
      w1 = __fma_rn(wg, pf[kFrames], w1);
      w2 = __fma_rn(wg, pf[2 * kFrames], w2);
      d0 = __fma_rn(q, dx, d0);
      d1 = __fma_rn(q, dy, d1);
      d2 = __fma_rn(q, dz, d2);
    }
  }
  if (!live) return;
  double* out = part + (static_cast<long long>(blockIdx.y) * n_sites + s) * kPlanes * n_frames + t;
  const double v[kPlanes] = {w0, w1, w2, d0, d1, d2};
#pragma unroll
  for (int c = 0; c < kPlanes; ++c) out[static_cast<long long>(c) * n_frames] = v[c];
}

// One thread per (site, frame): the P slices added in slice order, then
// W + kbt D rounded once to fp32 into out (T, S, 3).
__global__ void __launch_bounds__(kFinalizeThreads)
gb_apply_finalize(const double* __restrict__ part, int n_slices, int n_frames, int n_sites,
                  double kbt, float* __restrict__ out) {
  const long long idx = static_cast<long long>(blockIdx.x) * kFinalizeThreads + threadIdx.x;
  if (idx >= static_cast<long long>(n_sites) * n_frames) return;
  const int s = static_cast<int>(idx / n_frames);
  const long long t = idx - static_cast<long long>(s) * n_frames;
  const long long plane = static_cast<long long>(n_frames);
  const long long slice = static_cast<long long>(n_sites) * kPlanes * plane;
  double v[kPlanes] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
  for (int p = 0; p < n_slices; ++p) {
    const double* src = part + p * slice + static_cast<long long>(s) * kPlanes * plane + t;
#pragma unroll
    for (int c = 0; c < kPlanes; ++c) v[c] += src[c * plane];
  }
  float* dst = out + (t * n_sites + s) * 3;
#pragma unroll
  for (int c = 0; c < 3; ++c) dst[c] = __double2float_rn(fma(kbt, v[3 + c], v[c]));
}

// Stages of kChunk groups: the most group slices, and the prologue's grid.
long long stages_of(int n_groups) { return (n_groups + kChunk - 1LL) / kChunk; }

// Blocks of the main grid for one slice, or 0 for sizes it does not take.
long long apply_items(int n_frames, int n_atoms, int n_sites, int n_groups, int n_basis) {
  if (n_frames < 1 || n_atoms < 1 || n_sites < 1 || n_groups < 1 || n_basis < 1 ||
      n_basis > kMaxBasis) {
    return 0;
  }
  const long long tiles = (n_frames + kFrames - 1LL) / kFrames;
  const long long items = tiles * ((n_sites + kSiteRows - 1LL) / kSiteRows);
  const long long finals = (static_cast<long long>(n_sites) * n_frames + kFinalizeThreads - 1) /
                           kFinalizeThreads;
  if (items > 0x7fffffffLL || finals > 0x7fffffffLL || tiles > 0x7fffffffLL ||
      stages_of(n_groups) > kMaxSlices) {
    return 0;
  }
  return items;
}

size_t smem_bytes(int n_basis) {
  return sizeof(double) * (2 * kChunk * 3 * kFrames + kSiteRows * kChunk * (n_basis + 1) +
                           kChunk + n_basis);
}

}  // namespace

// Group slices P of a launch on the current device: enough that the grid
// holds about kBlocksPerSm blocks per SM, 1 when the frame tiles and site
// blocks alone do, never more slices than stages of kChunk groups. The
// caller's workspace holds P x S x 6 x T doubles. Returns P >= 1, 0 for
// sizes the kernels do not take, or minus the cudaError_t when the device
// cannot be read.
extern "C" int aggforce_gb_apply_slices(int n_frames, int n_atoms, int n_sites, int n_groups,
                                        int n_basis) {
  const long long items = apply_items(n_frames, n_atoms, n_sites, n_groups, n_basis);
  if (items == 0) return 0;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return -static_cast<int>(err);
  long long p = (static_cast<long long>(kBlocksPerSm) * sms + items - 1) / items;
  if (p > stages_of(n_groups)) p = stages_of(n_groups);
  if (p > kMaxSlices) p = kMaxSlices;
  return p < 1 ? 1 : static_cast<int>(p);
}

// Launches the three kernels on `stream` and returns the first cudaError_t
// (0 when every launch was accepted), or kBadArgs (negative) for sizes it
// does not take. forces and coords (T, N, 3), cg (T, S, 3), coefs (S, K_exp)
// with K_exp = G (1 + n_basis) when include_id, else G n_basis (id block,
// then (G, n_basis) g-major) and counts (G,) are device pointers to
// contiguous float32 arrays, centers (n_basis,) to float64; offsets
// (G + 1,) and atoms (offsets[G],) int32 list each group's atoms. gpos and
// fg (G, 3, T) and part (n_slices, S, 6, T), all float64, are the caller's
// workspace, n_slices from aggforce_gb_apply_slices; out (T, S, 3) float32
// is the output.
extern "C" int aggforce_gb_apply(const float* forces, const float* coords, const float* cg,
                                 const float* coefs, const int* offsets, const int* atoms,
                                 const float* counts, const double* centers, int n_frames,
                                 int n_atoms, int n_sites, int n_groups, int n_basis,
                                 int include_id, double width, double clip, double kbt,
                                 int n_slices, double* gpos, double* fg, double* part,
                                 float* out, void* stream) {
  const long long items = apply_items(n_frames, n_atoms, n_sites, n_groups, n_basis);
  if (items == 0 || n_slices < 1 || n_slices > stages_of(n_groups) ||
      !(width > 0.0 && width < INFINITY)) {
    return kBadArgs;
  }
  Basis basis;
  basis.inv_width = 1.0 / width;
  basis.neg2_inv_width = -2.0 / width;
  basis.clip = clip;
  // raw > clip for every raw when clip <= 0, for none when clip is NaN
  basis.live_off2 = clip > 0.0 ? -std::log(clip) : (clip <= 0.0 ? INFINITY : NAN);
  const size_t smem = smem_bytes(n_basis);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaFuncSetAttribute(
      gb_apply_partial, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned tiles = static_cast<unsigned>((n_frames + kFrames - 1LL) / kFrames);
  gb_group_planes<<<dim3(tiles, static_cast<unsigned>(stages_of(n_groups))), kThreads, 0, st>>>(
      forces, coords, offsets, atoms, counts, n_frames, n_atoms, n_groups, gpos, fg);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  gb_apply_partial<<<dim3(static_cast<unsigned>(items), n_slices), kThreads, smem, st>>>(
      gpos, fg, cg, coefs, counts, centers, include_id ? 1 : 0, n_frames, n_sites, n_groups,
      n_basis, basis, part);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long finals =
      (static_cast<long long>(n_sites) * n_frames + kFinalizeThreads - 1) / kFinalizeThreads;
  gb_apply_finalize<<<static_cast<unsigned>(finals), kFinalizeThreads, 0, st>>>(
      part, n_slices, n_frames, n_sites, kbt, out);
  return static_cast<int>(cudaGetLastError());
}
