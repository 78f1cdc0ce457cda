// The two stages shared by the featurized Gram kernels (site_grams.cu,
// site_grams_tiled.cu): build the design rows of a frame chunk once, then
// take their Gram on the tensor cores in 3xTF32.
//
// A design row (frame t, Cartesian component a) of cg site s has
// K_pad = G_pad * (1 + n_basis) columns in the k-major layout: block 0 is the
// id columns fg_a[t,g]; column c = G_pad + k*G_pad + g of block k + 1 >= 1 is
//
//     fg_a[t,g]*gz + dph*u_a,    disp = gpos[:,t,g] - cg[s,:,t],
//     d = |disp|,  u = disp / max(d, 1e-30),  off = (d - center) / w,
//     raw = exp(-off^2),  gz = max(raw, clip) - clip,
//     dph = kcount * [raw > clip] * raw * (-2/w) * off * mask[t],
//
// with center and kcount read at (k, g) through strides, so one build serves
// per-column parameters (site_grams.cu) and per-basis/per-group ones
// (site_grams_tiled.cu).
//
// Stage 1, build (`site_grams_build`): one thread per (frame, group) of a
// chunk of `tc` frames computes d, 1/d and u once, then for every site and
// every column of its group writes the three components into a K-major
// scratch (S, k_alloc, 3*tc): scratch[s][c][a*tc + tt], the reduction axis
// contiguous. Every design-row element is built once per launch. Frames past
// T are written as zero rows, so no product needs a frame mask.
//
// Stage 2, product (`site_grams_product`): one block of four warpgroups per
// (upper-triangle 128x128 output tile, site) runs scratch^T scratch over the
// chunk's 3*tc rows, 32 rows per pipeline stage. Two producer warpgroups
// load the two raw operand panels (128 columns x 32 rows) by TMA into a
// 3-slot ring and split them into TF32 hi and lo panels, hi = x rounded to TF32,
// lo = (x - hi) rounded, in a 2-slot ring; two consumer warpgroups, each
// owning 64 tile rows, run wgmma m64n128k8 TF32 from those panels with three
// products per fp32 product, lo*hi + hi*lo + hi*hi. Mbarriers hand the slots
// over, so loads, splits and products of neighbouring stages overlap. A
// single TF32 pass is ~1.6e-5 of the largest entry from a float64 sum; the
// split keeps fp32 accuracy. The tensor core sums in fp32 with truncation,
// a bias that grows with every step it accumulates (3.3e-5 over 3,072-row
// chunks), so the frame sum is taken in three levels: each stage's 12
// products from zero in the tensor core, the stage sums into fp32 registers
// by rounded adds, each chunk's fp32 sum into an fp64 tile in device memory
// that the block owning the tile reads and writes (no atomics, the same
// result from run to run). The last chunk hands its totals to the caller's
// store functor, which writes the upper triangle (i <= j) and whatever
// mirror its output contract wants.
//
// What bounds it: the tensor cores' TF32 rate, three products per fp32
// product. On the card the producer's split and the products take
// comparable times (PERF.md).
//
// The caller allocates the workspace and passes its layout (tc, k_alloc and
// the running tiles per site); run_gram refuses a layout other than its own
// with kBadWorkspace instead of writing past it.

#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <vector>

namespace gram_tc {

constexpr int kTile = 128;       // output tile edge (K_pad rounded up to it)
constexpr int kDepth = 32;       // design rows per pipeline stage
constexpr int kFrameBlock = 32;  // build stage: frames per block (and tc's unit)
constexpr int kGroupBlock = 32;  // build stage: groups per block
constexpr int kAddRunning = 1;   // product mode: add the fp64 running tile
constexpr int kFinal = 2;        // product mode: store the totals
constexpr int kBadWorkspace = -1;  // run_gram's return for a foreign layout

struct Operands {
  const float* gpos;     // (3, T, G_pad) group positions
  const float* cg;       // (S, 3, T) site positions
  const float* fg;       // (3, T, G_pad) group force sums, mask folded in
  const float* mask;     // (T,) frame validity
  const float* centers;  // basis centers, read at k*center_k + g*center_g
  const float* kcounts;  // kbt * group size, read at k*kcount_k + g*kcount_g
  int center_k, center_g, kcount_k, kcount_g;
  int n_sites, n_frames, g_pad, n_basis;
  float inv_w;   // 1 / width
  float dscale;  // -2 / width
  float clip;
};

// Stage 1: design rows of frames [t0, t0 + tc) for every site, into
// scratch[s][c][a*tc + tt]. Block (32 frames x 32 groups), threads (32, 8):
// positions and forces are staged through shared memory so that the reads
// run along groups and the writes along frames, both coalesced.
__global__ void __launch_bounds__(kFrameBlock * 8)
    site_grams_build(Operands p, float* __restrict__ scratch, int t0, int tc,
                     int k_alloc) {
  __shared__ float pos_s[3][kFrameBlock][kGroupBlock + 1];
  __shared__ float fg_s[3][kFrameBlock][kGroupBlock + 1];
  const int x = threadIdx.x;
  const int y = threadIdx.y;
  const int tt0 = blockIdx.x * kFrameBlock;
  const int g0 = blockIdx.y * kGroupBlock;
  const size_t plane = static_cast<size_t>(p.n_frames) * p.g_pad;
  for (int r = y; r < kFrameBlock; r += 8) {
    const int t = t0 + tt0 + r;
    const int g = g0 + x;
    const bool ok = t < p.n_frames && g < p.g_pad;
    const size_t tg = static_cast<size_t>(t) * p.g_pad + g;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      pos_s[a][r][x] = ok ? p.gpos[a * plane + tg] : 0.0f;
      fg_s[a][r][x] = ok ? p.fg[a * plane + tg] : 0.0f;
    }
  }
  __syncthreads();

  // thread (x, y): frame tt0 + x, groups g0 + y + 8q
  const int tt = tt0 + x;
  const int t = t0 + tt;
  const bool live_frame = t < p.n_frames;
  const float m = live_frame ? p.mask[t] : 0.0f;
  const size_t col_len = 3 * static_cast<size_t>(tc);
  for (int s = 0; s < p.n_sites; ++s) {
    float c0 = 0.0f, c1 = 0.0f, c2 = 0.0f;
    if (live_frame) {
      const float* cg_s = p.cg + static_cast<size_t>(s) * 3 * p.n_frames;
      c0 = cg_s[t];
      c1 = cg_s[p.n_frames + t];
      c2 = cg_s[2 * p.n_frames + t];
    }
    float* out_s = scratch + static_cast<size_t>(s) * k_alloc * col_len + tt;
    for (int r = y; r < kGroupBlock; r += 8) {
      const int g = g0 + r;
      if (g >= p.g_pad) break;  // uniform across the warp (one y per warp)
      const float f0 = fg_s[0][x][r];
      const float f1 = fg_s[1][x][r];
      const float f2 = fg_s[2][x][r];
      // a frame past T has zero positions, site and forces: a zero row
      const float x0 = live_frame ? pos_s[0][x][r] - c0 : 0.0f;
      const float x1 = live_frame ? pos_s[1][x][r] - c1 : 0.0f;
      const float x2 = live_frame ? pos_s[2][x][r] - c2 : 0.0f;
      const float d = sqrtf(x0 * x0 + x1 * x1 + x2 * x2);
      const float inv_d = 1.0f / fmaxf(d, 1e-30f);
      const float u0 = x0 * inv_d;
      const float u1 = x1 * inv_d;
      const float u2 = x2 * inv_d;
      float* col = out_s + static_cast<size_t>(g) * col_len;
      col[0] = f0;
      col[tc] = f1;
      col[2 * tc] = f2;
      for (int k = 0; k < p.n_basis; ++k) {
        const float center = p.centers[k * p.center_k + g * p.center_g];
        const float kc = p.kcounts[k * p.kcount_k + g * p.kcount_g];
        const float off = (d - center) * p.inv_w;
        const float raw = expf(-(off * off));
        const float gz = fmaxf(raw, p.clip) - p.clip;
        const float live = raw > p.clip ? 1.0f : 0.0f;
        const float dph = kc * live * raw * p.dscale * off * m;
        col = out_s + static_cast<size_t>((k + 1) * p.g_pad + g) * col_len;
        col[0] = f0 * gz + dph * u0;
        col[tc] = f1 * gz + dph * u1;
        col[2 * tc] = f2 * gz + dph * u2;
      }
    }
  }
}

// x = hi + lo with hi, lo TF32, each rounded to nearest with ties away from
// zero as cvt.rna.tf32.f32 does, in integer adds and masks (full-rate ALU
// instructions, where cvt runs at a fraction of that rate)
__device__ __forceinline__ uint32_t round_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = round_tf32(x);
  lo = round_tf32(x - __uint_as_float(hi));
}

// Stage 2: the chunk's Gram tile (ti, tj), ti <= tj, of site blockIdx.y, on
// TMA, mbarriers and wgmma.

constexpr int kRawSlots = 3;                 // raw panel ring
constexpr int kSplitSlots = 2;               // hi/lo panel ring
constexpr int kPanel = kTile * kDepth;       // floats per panel (16 KB)
constexpr int kPanelBytes = kPanel * 4;
constexpr int kConsumers = 256;              // warpgroups 0 and 1: 64 tile rows each
constexpr int kProducers = 256;              // warpgroups 2 and 3: TMA and the split
constexpr int kThreads = kConsumers + kProducers;
// registers per thread after setmaxnreg: the consumers hold two 64-float
// accumulators, the producers little; 256 * (216 + 40) = 65,536
constexpr int kConsumerRegs = 216;
constexpr int kProducerRegs = 40;
// 1,024 bytes of alignment slack (the 128-byte swizzle repeats every 1,024),
// the two rings and their mbarriers
constexpr size_t kSmemBytes =
    1024 + (size_t(kRawSlots) * 2 + size_t(kSplitSlots) * 4) * kPanelBytes +
    2 * (kRawSlots + kSplitSlots) * sizeof(uint64_t);

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// K-major, 128-byte swizzle: 8-row groups 1,024 bytes apart
__device__ __forceinline__ uint64_t sw128_desc(const float* p) {
  uint64_t d = static_cast<uint64_t>((smem_addr(p) & 0x3FFFF) >> 4);
  d |= static_cast<uint64_t>(1) << 16;
  d |= static_cast<uint64_t>(1024 >> 4) << 32;
  d |= static_cast<uint64_t>(1) << 62;
  return d;
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("{\n.reg .b64 state;\nmbarrier.arrive.shared::cta.b64 state, [%0];\n}\n" ::"r"(
                   smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_bytes(uint64_t* bar, int bytes) {
  asm volatile(
      "{\n.reg .b64 state;\nmbarrier.arrive.expect_tx.shared::cta.b64 state, [%0], %1;\n}\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes) : "memory");
}

// wait until the phase of parity `parity` of `bar` has completed; a wait
// that outlasts ~2^22 polls traps, so a broken pipeline fails instead of
// spinning until the process is killed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  for (int polls = 0;; ++polls) {
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred P1;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 P1, [%1], %2;\n"
        "selp.u32 %0, 1, 0, P1;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (polls > (1 << 22)) asm volatile("trap;");
  }
}

__device__ __forceinline__ void tma_load(float* dst, const CUtensorMap* map, int k0,
                                         int row, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(k0), "r"(row), "r"(smem_addr(bar))
      : "memory");
}

#define WGMMA_D8(i)                                                      \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d (+)= a * b on the tensor cores for one warpgroup: 64 x 128 fp32 tile,
// k = 8, both TF32 operands K-major in shared memory; d is summed from zero
// when scale_d is 0

__device__ __forceinline__ void wgmma_tf32_ss(float (&d)[64], uint64_t desc_a,
                                              uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1;\n"
      "}\n"
      : WGMMA_D8(0), WGMMA_D8(8), WGMMA_D8(16), WGMMA_D8(24), WGMMA_D8(32),
        WGMMA_D8(40), WGMMA_D8(48), WGMMA_D8(56)
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

template <class Store>
__global__ void __launch_bounds__(kThreads, 1)
    site_grams_product(const __grid_constant__ CUtensorMap map,
                       double* __restrict__ running, Store store, int n_tiles,
                       int k_alloc, int depth, int mode) {
  extern __shared__ __align__(1024) unsigned char smem_bytes[];
  float* base = reinterpret_cast<float*>(
      smem_bytes + ((1024 - (smem_addr(smem_bytes) & 1023)) & 1023));
  float* raw = base;                               // [kRawSlots][A, B]
  float* split = base + kRawSlots * 2 * kPanel;   // [kSplitSlots][A hi, A lo, B hi, B lo]
  uint64_t* bars = reinterpret_cast<uint64_t*>(split + kSplitSlots * 4 * kPanel);
  uint64_t* raw_full = bars;
  uint64_t* raw_empty = raw_full + kRawSlots;
  uint64_t* split_full = raw_empty + kRawSlots;
  uint64_t* split_empty = split_full + kSplitSlots;

  int ti = 0;
  int rem = blockIdx.x;
  while (rem >= n_tiles - ti) {
    rem -= n_tiles - ti;
    ++ti;
  }
  const int tj = ti + rem;
  const bool diag = ti == tj;  // one panel serves as both operands
  const int s = blockIdx.y;
  const int n_steps = depth / kDepth;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int i = 0; i < kRawSlots; ++i) {
      mbar_init(raw_full + i, 1);
      mbar_init(raw_empty + i, kProducers);
    }
    for (int i = 0; i < kSplitSlots; ++i) {
      mbar_init(split_full + i, kProducers);
      mbar_init(split_empty + i, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // producer warpgroups: load, then split, kRawSlots - 1 stages behind
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    const int p = tid - kConsumers;
    const int row_a = s * k_alloc + ti * kTile;
    const int row_b = s * k_alloc + tj * kTile;
    constexpr int kLag = kRawSlots - 1;
    for (int i = 0; i < n_steps + kLag; ++i) {
      if (i < n_steps && p == 0) {
        const int slot = i % kRawSlots;
        mbar_wait(raw_empty + slot, ((i / kRawSlots) & 1) ^ 1);
        float* ra = raw + slot * 2 * kPanel;
        mbar_expect_bytes(raw_full + slot, (diag ? 1 : 2) * kPanelBytes);
        tma_load(ra, &map, i * kDepth, row_a, raw_full + slot);
        if (!diag) tma_load(ra + kPanel, &map, i * kDepth, row_b, raw_full + slot);
      }
      const int j = i - kLag;
      if (j >= 0) {
        const int slot = j % kRawSlots;
        const int s2 = j % kSplitSlots;
        mbar_wait(raw_full + slot, (j / kRawSlots) & 1);
        mbar_wait(split_empty + s2, ((j / kSplitSlots) & 1) ^ 1);
        const float* ra = raw + slot * 2 * kPanel;
        float* sp = split + s2 * 4 * kPanel;
        const int n_panels = diag ? 1 : 2;
        for (int panel = 0; panel < n_panels; ++panel) {
          const float* src = ra + panel * kPanel;
          float* hi = sp + panel * 2 * kPanel;
          float* lo = hi + kPanel;
#pragma unroll 4
          for (int q = 0; q < kPanel / 4 / kProducers; ++q) {
            const int o = (p + q * kProducers) * 4;
            const float4 x = *reinterpret_cast<const float4*>(src + o);
            uint32_t h0, h1, h2, h3, l0, l1, l2, l3;
            split_tf32(x.x, h0, l0);
            split_tf32(x.y, h1, l1);
            split_tf32(x.z, h2, l2);
            split_tf32(x.w, h3, l3);
            *reinterpret_cast<uint4*>(hi + o) = make_uint4(h0, h1, h2, h3);
            *reinterpret_cast<uint4*>(lo + o) = make_uint4(l0, l1, l2, l3);
          }
        }
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        mbar_arrive(split_full + s2);
        mbar_arrive(raw_empty + slot);
      }
    }
    return;
  }

  // consumer warpgroups
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int wg = tid >> 7;
  float acc[64];
  float part[64];
#pragma unroll
  for (int v = 0; v < 64; ++v) acc[v] = part[v] = 0.0f;
  for (int j = 0; j < n_steps; ++j) {
    const int s2 = j % kSplitSlots;
    mbar_wait(split_full + s2, (j / kSplitSlots) & 1);
    const float* sp = split + s2 * 4 * kPanel;
    const float* b_hi = diag ? sp : sp + 2 * kPanel;
    const float* b_lo = b_hi + kPanel;
    // this warpgroup's 64 rows of A start 64 x 128 bytes into the panel
    const uint64_t a_hi = sw128_desc(sp + wg * 64 * kDepth);
    const uint64_t a_lo = sw128_desc(sp + kPanel + wg * 64 * kDepth);
    const uint64_t d_hi = sw128_desc(b_hi);
    const uint64_t d_lo = sw128_desc(b_lo);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int s8 = 0; s8 < 4; ++s8) {
      const uint64_t off = static_cast<uint64_t>(s8 * 8 * 4) >> 4;  // 32 bytes of k
      wgmma_tf32_ss(part, a_lo + off, d_hi + off, s8 > 0);
      wgmma_tf32_ss(part, a_hi + off, d_lo + off, 1);
      wgmma_tf32_ss(part, a_hi + off, d_hi + off, 1);
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    mbar_arrive(split_empty + s2);
#pragma unroll
    for (int v = 0; v < 64; ++v) acc[v] += part[v];
  }

  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int row0 = wg * 64 + (warp & 3) * 16 + (lane >> 2);
  const int tig = lane & 3;
  double* run = running +
                (static_cast<size_t>(s) * gridDim.x + blockIdx.x) * kTile * kTile;
#pragma unroll
  for (int v = 0; v < 64; ++v) {
    double* slot = run + v * kConsumers + tid;
    double total = acc[v];
    if (mode & kAddRunning) total += *slot;
    if (mode & kFinal) {
      const int jj = v >> 2;
      const int r = v & 3;
      const int row = ti * kTile + row0 + (r >= 2 ? 8 : 0);
      const int col = tj * kTile + jj * 8 + 2 * tig + (r & 1);
      store(s, row, col, static_cast<float>(total));
    } else {
      *slot = total;
    }
  }
}

// Host side: the chunk loop on `stream`, build then product per chunk of tc
// frames; the product reads the scratch through one TMA map, a 2-D view of
// (S * k_alloc columns, 3*tc rows) with 32 x 128 boxes. The workspace is the
// caller's: scratch (S, k_alloc, 3*tc) float32 with zero columns past K_pad,
// running (S, n_running, 128*128) float64, n_running the upper-triangle tile
// count when T takes more than one chunk, else 0. Returns kBadWorkspace if
// tc, k_alloc or n_running is not that layout, else the first cudaError_t.
// With `stage_ms` (host, two floats) it also records CUDA events between the
// launches, waits for the last, and writes the device milliseconds of the
// build and the product stages, each summed over the chunks.
template <class Store>
int run_gram(const Operands& p, Store store, float* scratch, double* running,
             int tc, int k_alloc, int n_running, float* stage_ms,
             cudaStream_t stream) {
  const int k_pad = p.g_pad * (1 + p.n_basis);
  const int n_tiles = (k_pad + kTile - 1) / kTile;
  const int n_upper = n_tiles * (n_tiles + 1) / 2;
  if (tc <= 0 || tc % kFrameBlock != 0) return kBadWorkspace;
  const int n_chunks = p.n_frames > tc ? (p.n_frames + tc - 1) / tc : 1;
  if (k_alloc != n_tiles * kTile || n_running != (n_chunks > 1 ? n_upper : 0))
    return kBadWorkspace;
  if (stage_ms != nullptr) stage_ms[0] = stage_ms[1] = 0.0f;
  if (p.n_sites <= 0 || n_upper <= 0) return static_cast<int>(cudaSuccess);
  cudaError_t err = cudaFuncSetAttribute(
      site_grams_product<Store>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  static PFN_cuTensorMapEncodeTiled_v12000 encode = nullptr;
  if (encode == nullptr) {
    cudaDriverEntryPointQueryResult found;
    err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled",
                                  reinterpret_cast<void**>(&encode),
                                  cudaEnableDefault, &found);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (found != cudaDriverEntryPointSuccess) return static_cast<int>(cudaErrorNotSupported);
  }
  const int depth = 3 * tc;
  CUtensorMap map;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(depth),
                              static_cast<cuuint64_t>(p.n_sites) * k_alloc};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(depth) * sizeof(float)};
  const cuuint32_t box[2] = {kDepth, kTile};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult made = encode(&map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, scratch, dims,
                               strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                               CU_TENSOR_MAP_SWIZZLE_128B,
                               CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (made != CUDA_SUCCESS) return static_cast<int>(cudaErrorInvalidValue);
  // marks[2c] before chunk c's build, marks[2c + 1] between its build and
  // its product, marks[2n] after the last product
  std::vector<cudaEvent_t> marks(stage_ms != nullptr ? 2 * n_chunks + 1 : 0);
  for (cudaEvent_t& e : marks) {
    err = cudaEventCreate(&e);
    if (err != cudaSuccess) {
      e = nullptr;
      break;
    }
  }
  const dim3 build_grid(tc / kFrameBlock, (p.g_pad + kGroupBlock - 1) / kGroupBlock);
  const dim3 build_block(kFrameBlock, 8);
  const dim3 grid(n_upper, p.n_sites);
  for (int c = 0; c < n_chunks && err == cudaSuccess; ++c) {
    if (!marks.empty()) cudaEventRecord(marks[2 * c], stream);
    site_grams_build<<<build_grid, build_block, 0, stream>>>(p, scratch, c * tc,
                                                             tc, k_alloc);
    if (!marks.empty()) cudaEventRecord(marks[2 * c + 1], stream);
    const int mode = (c > 0 ? kAddRunning : 0) | (c + 1 == n_chunks ? kFinal : 0);
    site_grams_product<Store><<<grid, kThreads, kSmemBytes, stream>>>(
        map, running, store, n_tiles, k_alloc, depth, mode);
    err = cudaGetLastError();
  }
  if (!marks.empty() && err == cudaSuccess) {
    cudaEventRecord(marks.back(), stream);
    err = cudaEventSynchronize(marks.back());
    for (int c = 0; c < n_chunks && err == cudaSuccess; ++c) {
      float build = 0.0f, product = 0.0f;
      err = cudaEventElapsedTime(&build, marks[2 * c], marks[2 * c + 1]);
      if (err == cudaSuccess)
        err = cudaEventElapsedTime(&product, marks[2 * c + 1], marks[2 * c + 2]);
      stage_ms[0] += build;
      stage_ms[1] += product;
    }
  }
  for (cudaEvent_t e : marks)
    if (e != nullptr) cudaEventDestroy(e);
  return static_cast<int>(err);
}

}  // namespace gram_tc
