// Fused int8 dequantisation + GEMV / GEMM for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `int8_gemv_call` of the JAX package
// (src/repro/kernels/int8_gemv/kernel.py, body `_int8_gemv_kernel`):
//
//   y[m, n] = scale[n] * sum_k x[m, k] * w8[k, n]      (f32 accumulation)
//
// with x (M, K) in f32 or bf16, w8 int8 and one f32 scale per output
// column; y is f32. The weight is read through element strides, so one
// source serves both layouts of the drafter's quantized weights:
//   * "cols": w8 (K, N) with unit stride along N — the dense projections
//     wq/wk/wv/wo/wg/wu/wd;
//   * "rows": unit stride along K — the (V, D) embedding table read as
//     its transpose (K = D, N = V) for the quantized tied-logits head.
// HBM carries one byte per weight: int8 becomes f32 (or bf16) only in
// registers or shared memory. The Pallas kernel serves B <= 8 rows; this
// source serves any M through three paths, picked by the wrapper
// (`ops.py::plan`) from the shapes alone:
//
// 1. `splitk_kernel` — few rows (M < 5, or f32 x), cols layout. Bound by
//    the weight bytes over 3.35 TB/s, but at decode a 128- or 896-column
//    product is too small to fill 132 SMs when a block owns a column tile
//    over all of K, and launch plus load latency set the time. So a block
//    owns 16 columns (32 measured 2.5x slower on wg/wu) and K is split
//    over the blocks of a thread-block cluster (1-16 blocks; 16 is above
//    the portable 8 and needs NonPortableClusterSizeAllowed) until there
//    are ~100 blocks. Each of the 128 threads reads one row's 16 weight
//    bytes per 16-byte load, 8 rows in flight (4 for 8-row blocks); the
//    block stages its slice of x in shared memory as f32 once, with all
//    loads of a pass in flight (loading each row's x beside its weights
//    instead was 2-3x slower). The block's partial sums are added by a
//    fixed butterfly of shuffles over each warp's row lanes and then warp
//    by warp, and the cluster's partials in fixed rank order through
//    distributed shared memory (`map_shared_rank` after `cluster.sync()`,
//    every remote load in flight at once): one launch, no global scratch,
//    no atomics, the same bits every run. Each rank adds up and writes
//    its share of the tile's outputs. f32 x with more rows takes this
//    path in row blocks of 8 (f32 products stay f32; no serving phase
//    gives it).
// 2. `rows_kernel` — few rows (or f32 x), rows layout: the tied-logits
//    head, one pass over a V x D table (136 MB at qwen2-0.5b) that must
//    stream at HBM rate. A half-warp owns a column (16 lanes x 16 bytes
//    = 256 contiguous bytes per load) and each lane holds 8 columns, one
//    16-byte chunk of each in flight: 8 independent loads per lane and 16
//    columns per warp (8 columns x 1 chunk was faster than 4 x 2 or 4 x
//    4). Every column needs all of x, so x is staged in shared memory as
//    f32 once per block and each staged value feeds 8 columns; the grid
//    is the blocks that fit on the SMs at once, striding over the
//    columns, so x is staged a few hundred times, not once per 128
//    columns. Each column's sum is a fixed butterfly over its half-warp.
// 3. `tc_kernel` — bf16 x with M >= 5 (drafter prefill and extend), either
//    layout: tensor cores. Bound at 512 rows by the operations (bf16
//    dense 989 TFLOP/s), where CUDA-core f32 FMAs re-reading each weight
//    tile per 8-row block were 60x slower than a bf16 matmul. A block
//    owns 64 rows x BN (64 or 128) columns; tiles of w8 (int8) and x
//    (bf16) of BK = 64 go through a 3-stage shared-memory ring by 16-byte
//    `cp.async` (zero-filled past the ragged edges; byte loads where the
//    strides are not 16-byte aligned). Each w8 tile becomes bf16 in shared
//    memory — exact, every int8 value is a bf16 value — in the K-major
//    core-matrix layout (8 rows x 16 bytes) that `wgmma` reads without
//    swizzle, and one warpgroup runs `wgmma.mma_async.m64nBNk16` (bf16 in,
//    f32 accumulate; PTX inline, no CUTLASS) over it. (Two warpgroups
//    sharing each converted tile over 128 rows were faster on some shapes
//    and slower on others, and were taken out.) Where the
//    output tiles are too few to fill the SMs (extend rows, a long K), K
//    is split over a cluster and the tiles are added in rank order
//    through distributed shared memory, as in path 1. The column scale is
//    applied in the epilogue. A bf16 x int8 product is exact in f32, so
//    only the summation order differs from the plain version. wgmma (not
//    the `mma.sync` fallback design) landed.
//
// Crossover between paths 1 or 2 and 3 at bf16 x: see `ops.py::TC_MIN_ROWS`
// (measured by `chip_smoke.py`).
//
// The C entry points launch on the caller's stream, allocate nothing and
// return cudaGetLastError(); `int8_smem` reports a path's shared memory.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "../../csrc/smem_report.cuh"

namespace cg = cooperative_groups;

namespace {

// ---------------------------------------------------------------- shared

// Four signed bytes to f32 exactly: each byte (flipped to u = b + 128)
// becomes the mantissa of 2^23 + u, then 2^23 + 128 is subtracted; two
// full-rate ALU ops per value instead of a quarter-rate I2F.
__device__ __forceinline__ void i8x4_to_f32(uint32_t w, float* f) {
  const uint32_t u = w ^ 0x80808080u;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    f[j] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540u | j)) -
           8388736.f;
}

// byte j of each of 8 words (8 consecutive k of one column) as 4 packed
// bf16x2 (lower k in the low half). An int8 value's f32 has a zero low
// half, so its bf16 is the high half: exact.
__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  return __byte_perm(__float_as_uint(a), __float_as_uint(b), 0x7632u);
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int bytes) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Stage rows [m0, m0 + MB) x columns [k0, k0 + kn) of x into xs[mi * pitch
// + k] as f32 (zeros past M and in [kn, kp)). The loads of a pass are all
// issued before any is used, so staging costs a couple of round trips to
// memory, not one per element.
template <int MB, int THREADS, typename XT>
__device__ __forceinline__ void stage_x(float* xs, int pitch,
                                        const XT* __restrict__ x, int64_t sx,
                                        int m0, int M, int k0, int kn,
                                        int kp) {
  constexpr int UN = 16;
  const int total = MB * kp;
  for (int base = threadIdx.x; base < total; base += THREADS * UN) {
    float v[UN];
#pragma unroll
    for (int u = 0; u < UN; ++u) {
      const int i = base + u * THREADS;
      const int mi = i / kp, k = i - mi * kp;
      v[u] = (i < total && m0 + mi < M && k < kn)
                 ? to_f32(x[static_cast<int64_t>(m0 + mi) * sx + k0 + k])
                 : 0.f;
    }
#pragma unroll
    for (int u = 0; u < UN; ++u) {
      const int i = base + u * THREADS;
      const int mi = i / kp;
      if (i < total) xs[mi * pitch + i - mi * kp] = v[u];
    }
  }
}

// Sum v[0..N) over the 32 lanes of a warp: a fixed butterfly over lane
// bits OFF, OFF / 2, ..., 1 that halves the values at each step (the lane
// with the bit set keeps the upper half), so it costs about N shuffles,
// not 5 N. Afterwards a lane holds max(1, N >> 5) sums, of the value
// indices butterfly_base(lane) + [0, that); where N reached 1 early, the
// partner lanes hold the same sum and the one with the bit clear owns it
// (butterfly_shared bits).
template <int N, int OFF>
__device__ __forceinline__ void butterfly(float* v, int lane) {
  if constexpr (OFF >= 1) {
    if constexpr (N > 1) {
      const bool up = lane & OFF;
#pragma unroll
      for (int i = 0; i < N / 2; ++i) {
        const float send = up ? v[i] : v[i + N / 2];
        const float keep = up ? v[i + N / 2] : v[i];
        v[i] = keep + __shfl_xor_sync(0xffffffffu, send, OFF);
      }
      butterfly<N / 2, OFF / 2>(v, lane);
    } else {
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], OFF);
      butterfly<1, OFF / 2>(v, lane);
    }
  }
}
template <int N, int OFF>
__device__ __forceinline__ int butterfly_base(int lane) {
  if constexpr (OFF < 1) {
    return 0;
  } else if constexpr (N > 1) {
    return ((lane & OFF) ? N / 2 : 0) + butterfly_base<N / 2, OFF / 2>(lane);
  } else {
    return 0;
  }
}
template <int N, int OFF>
__host__ __device__ constexpr int butterfly_shared() {
  if constexpr (OFF < 1) return 0;
  else if constexpr (N > 1) return butterfly_shared<N / 2, OFF / 2>();
  else return OFF | butterfly_shared<1, OFF / 2>();
}
template <int N, int OFF>
__host__ __device__ constexpr int butterfly_kept() {
  if constexpr (OFF < 1 || N == 1) return N;
  else return butterfly_kept<N / 2, OFF / 2>();
}

// part[o] summed over the cluster's ranks 0..cs-1 in order: all remote
// loads are issued before the adds (zeros past cs add exactly).
__device__ __forceinline__ float cluster_sum(cg::cluster_group& cluster,
                                             float* part, int o, int cs) {
  float v[16];
#pragma unroll
  for (int q = 0; q < 16; ++q)
    v[q] = q < cs ? cluster.map_shared_rank(part, q)[o] : 0.f;
  float s = 0.f;
#pragma unroll
  for (int q = 0; q < 16; ++q) s += v[q];
  return s;
}

// ------------------------------------------------ 1. split-K, cols layout

constexpr int SK_THREADS = 128;
constexpr int SK_KC = 1024;      // rows of x staged at a time

__host__ __device__ constexpr size_t splitk_smem(int mb) {
  return static_cast<size_t>(mb) * SK_KC * 4;   // x chunk [mb][SK_KC] f32
}

// w8 element (k, n) at k * sk + n. Block (tile, rank) of a cluster of
// `cs` blocks: columns [tile * 16, +16), rows [rank * kslice, +kslice);
// thread r reads rows r, r + 128, ...
template <int MB, typename XT>
__global__ void __launch_bounds__(SK_THREADS)
splitk_kernel(const XT* __restrict__ x, const int8_t* __restrict__ w,
              const float* __restrict__ scale, float* __restrict__ y, int M,
              int K, int N, int64_t sx, int64_t sk, int vec, int cs,
              int kslice) {
  constexpr int TN = 16;
  constexpr int RIF = SK_THREADS;          // row lanes
  constexpr int SK_U = MB <= 4 ? 8 : 4;    // rows in flight per thread
  constexpr int V = MB * 16;               // partial sums per thread
  constexpr int WARPS = SK_THREADS / 32;
  extern __shared__ float4 sk_smem4[];
  float* xs = reinterpret_cast<float*>(sk_smem4);   // [MB][SK_KC]
  __shared__ float red[WARPS][V];                   // per warp
  __shared__ float part[MB * TN];

  const int tid = threadIdx.x;
  const int rank = blockIdx.x % cs;
  const int n0 = (blockIdx.x / cs) * TN;
  const int m0 = blockIdx.y * MB;
  const int kb = rank * kslice;
  const int ke = min(K, kb + kslice);
  const int valid = max(0, min(TN, N - n0));

  float acc[MB * 16];
#pragma unroll
  for (int i = 0; i < MB * 16; ++i) acc[i] = 0.f;

  for (int kc0 = kb; kc0 < ke; kc0 += SK_KC) {
    const int kn = min(SK_KC, ke - kc0);
    stage_x<MB, SK_THREADS>(xs, SK_KC, x, sx, m0, M, kc0, kn, kn);
    __syncthreads();
    for (int k0 = tid; k0 < kn; k0 += RIF * SK_U) {
      uint4 raw[SK_U];
#pragma unroll
      for (int u = 0; u < SK_U; ++u) {
        const int k = k0 + u * RIF;
        const int8_t* p = w + static_cast<int64_t>(kc0 + k) * sk + n0;
        if (k < kn && vec && valid == TN) {
          raw[u] = __ldg(reinterpret_cast<const uint4*>(p));
        } else {
          uint32_t b[4] = {0u, 0u, 0u, 0u};
          if (k < kn)
            for (int j = 0; j < valid; ++j)
              b[j / 4] |= static_cast<uint32_t>(static_cast<uint8_t>(p[j]))
                          << (8 * (j % 4));
          raw[u] = make_uint4(b[0], b[1], b[2], b[3]);
        }
      }
#pragma unroll
      for (int u = 0; u < SK_U; ++u) {
        const int k = k0 + u * RIF;
        if (k >= kn) break;
        float wf[16];
        i8x4_to_f32(raw[u].x, wf);
        i8x4_to_f32(raw[u].y, wf + 4);
        i8x4_to_f32(raw[u].z, wf + 8);
        i8x4_to_f32(raw[u].w, wf + 12);
#pragma unroll
        for (int mi = 0; mi < MB; ++mi) {
          const float xv = xs[mi * SK_KC + k];
#pragma unroll
          for (int j = 0; j < 16; ++j) acc[mi * 16 + j] += xv * wf[j];
        }
      }
    }
    __syncthreads();
  }

  // the block's partials: a butterfly over a warp's 32 row lanes, then
  // the warps added in order
  const int lane = tid % 32, warp = tid / 32;
  butterfly<V, 16>(acc, lane);
  constexpr int KEPT = butterfly_kept<V, 16>();
  if ((lane & butterfly_shared<V, 16>()) == 0) {
    const int base = butterfly_base<V, 16>(lane);
#pragma unroll
    for (int i = 0; i < KEPT; ++i) red[warp][base + i] = acc[i];
  }
  __syncthreads();
  for (int o = tid; o < MB * TN; o += SK_THREADS) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) s += red[w][o];
    part[o] = s;
  }
  if (cs == 1) {
    __syncthreads();
    for (int o = tid; o < MB * TN; o += SK_THREADS) {
      const int m = m0 + o / TN, n = n0 + o % TN;
      if (m < M && n < N) y[static_cast<int64_t>(m) * N + n] = part[o] * scale[n];
    }
    return;
  }
  // the cluster's partials, added in fixed rank order; rank q writes the
  // outputs o = q, q + cs, ...
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  for (int o = rank + cs * tid; o < MB * TN; o += cs * SK_THREADS) {
    const float s = cluster_sum(cluster, part, o, cs);
    const int m = m0 + o / TN, n = n0 + o % TN;
    if (m < M && n < N) y[static_cast<int64_t>(m) * N + n] = s * scale[n];
  }
  cluster.sync();   // no block leaves while another reads its partials
}

// ------------------------------------------------ 2. rows layout (head)

constexpr int RW_THREADS = 256;
constexpr int RW_CPL = 8;        // columns per lane (and per half-warp)
constexpr int RW_U = 1;          // 16-byte chunks per column in flight
constexpr int RW_CPB = (RW_THREADS / 32) * 2 * RW_CPL;   // 128 per block pass
constexpr int RW_SMEM_MAX = 200 * 1024;

constexpr int rows_smem(int mb, int K) {
  return mb * ((K + 15) & ~15) * 4;   // x rows [mb][Kp] f32
}

// w8 element (k, n) at n * sn + k. x rows [m0, m0 + MB) staged as f32;
// warp w of block b owns columns (b * 8 + w + i * gridDim.x * 8) * 16 +
// half * 8 + j; lane g of its half reads chunks g, g + 16, ...
template <int MB, typename XT>
__global__ void __launch_bounds__(RW_THREADS)
rows_kernel(const XT* __restrict__ x, const int8_t* __restrict__ w,
            const float* __restrict__ scale, float* __restrict__ y, int M,
            int K, int N, int64_t sx, int64_t sn, int vec) {
  extern __shared__ float4 rw_smem4[];
  float* xs = reinterpret_cast<float*>(rw_smem4);   // [MB][Kp]
  const int Kp = (K + 15) & ~15;
  const int nch = Kp / 16;
  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * MB;
  stage_x<MB, RW_THREADS>(xs, Kp, x, sx, m0, M, 0, K, Kp);
  __syncthreads();
  const int warp = tid / 32, lane = tid % 32;
  const int half = lane / 16, g = lane % 16;
  constexpr int CPW = 2 * RW_CPL;   // columns per warp
  const int groups = (N + CPW - 1) / CPW;
  for (int grp = blockIdx.x * (RW_THREADS / 32) + warp; grp < groups;
       grp += gridDim.x * (RW_THREADS / 32)) {
    const int nb = grp * CPW + half * RW_CPL;
    const int8_t* wc[RW_CPL];
#pragma unroll
    for (int j = 0; j < RW_CPL; ++j)
      wc[j] = w + static_cast<int64_t>(min(nb + j, N - 1)) * sn;
    float acc[RW_CPL][MB];
#pragma unroll
    for (int j = 0; j < RW_CPL; ++j)
#pragma unroll
      for (int mi = 0; mi < MB; ++mi) acc[j][mi] = 0.f;
    for (int c0 = g; c0 < nch; c0 += 16 * RW_U) {
      uint4 raw[RW_U][RW_CPL];
#pragma unroll
      for (int u = 0; u < RW_U; ++u) {
        const int k = (c0 + 16 * u) * 16;
#pragma unroll
        for (int j = 0; j < RW_CPL; ++j) {
          if (vec && k + 16 <= K) {
            raw[u][j] = __ldg(reinterpret_cast<const uint4*>(wc[j] + k));
          } else {
            uint32_t b[4] = {0u, 0u, 0u, 0u};
            for (int e = 0; e < 16 && k + e < K; ++e)
              b[e / 4] |= static_cast<uint32_t>(static_cast<uint8_t>(wc[j][k + e]))
                          << (8 * (e % 4));
            raw[u][j] = make_uint4(b[0], b[1], b[2], b[3]);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < RW_U; ++u) {
        const int c = c0 + 16 * u;
        if (c >= nch) break;
#pragma unroll
        for (int q = 0; q < 4; ++q) {   // 4 of the chunk's 16 k at a time
          float wf[RW_CPL][4];
#pragma unroll
          for (int j = 0; j < RW_CPL; ++j) {
            const uint32_t word = q == 0 ? raw[u][j].x
                                  : q == 1 ? raw[u][j].y
                                  : q == 2 ? raw[u][j].z
                                           : raw[u][j].w;
            i8x4_to_f32(word, wf[j]);
          }
#pragma unroll
          for (int mi = 0; mi < MB; ++mi) {
            const float4 xv =
                *reinterpret_cast<const float4*>(xs + mi * Kp + c * 16 + q * 4);
#pragma unroll
            for (int j = 0; j < RW_CPL; ++j)
              acc[j][mi] += xv.x * wf[j][0] + xv.y * wf[j][1] +
                            xv.z * wf[j][2] + xv.w * wf[j][3];
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < RW_CPL; ++j)
#pragma unroll
      for (int mi = 0; mi < MB; ++mi)
#pragma unroll
        for (int off = 8; off > 0; off >>= 1)
          acc[j][mi] += __shfl_xor_sync(0xffffffffu, acc[j][mi], off);
    if (g == 0) {
#pragma unroll
      for (int j = 0; j < RW_CPL; ++j) {
        const int n = nb + j;
        if (n >= N) continue;
        const float sc = scale[n];
#pragma unroll
        for (int mi = 0; mi < MB; ++mi)
          if (m0 + mi < M)
            y[static_cast<int64_t>(m0 + mi) * N + n] = acc[j][mi] * sc;
      }
    }
  }
}

// ------------------------------------------------ 3. tensor cores (wgmma)

constexpr int TC_THREADS = 128;  // one warpgroup
constexpr int TC_BM = 64;
constexpr int TC_BK = 64;
constexpr int TC_STAGES = 3;

template <int BN>
struct TcSmem {
  static constexpr int A_BYTES = TC_BM * TC_BK * 2;   // bf16 x tile
  static constexpr int W_BYTES = TC_BK * BN;          // int8 w tile
  static constexpr int STAGE = A_BYTES + W_BYTES;
  static constexpr int B_BYTES = BN * TC_BK * 2;      // bf16 w tile
  static constexpr int TOTAL = TC_STAGES * STAGE + B_BYTES;
};

// wgmma shared-memory descriptor, no swizzle: core matrices of 8 rows x
// 16 bytes (128 contiguous bytes); `lbo` = bytes between the two core
// matrices along K, `sbo` = bytes between 8-row groups along M / N.
__device__ __forceinline__ uint64_t make_desc(const void* p, uint32_t lbo,
                                              uint32_t sbo) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return static_cast<uint64_t>((a & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16) |
         (static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t da,
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t da,
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, "
      "1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

template <int BN>
__device__ __forceinline__ void wgmma_tile(float (&d)[BN / 2], uint64_t da,
                                           uint64_t db) {
  if constexpr (BN == 64) wgmma_n64(d, da, db);
  else wgmma_n128(d, da, db);
}

// Issue the copies of k-tile `kt` into ring stage `st`: the x tile into
// the A core-matrix layout (16-byte chunk (row r, k-chunk c) at
// c * BM * 16 + r * 16) and the raw int8 tile as stored (cols: [BK][BN],
// rows: [BN][BK]). Out-of-range bytes are zero-filled.
template <int BN, bool ROWS>
__device__ __forceinline__ void tc_load(
    uint8_t* stage, const __nv_bfloat16* __restrict__ x,
    const int8_t* __restrict__ w, int M, int K, int N, int64_t sx,
    int64_t sw, int m0, int n0, int kt, int vec_x, int vec_w) {
  const int tid = threadIdx.x;
  const int k0 = kt * TC_BK;
  uint8_t* a_s = stage;
  uint8_t* w_s = stage + TcSmem<BN>::A_BYTES;
  // x: 64 rows x 8 chunks of 8 bf16
  for (int i = tid; i < TC_BM * (TC_BK / 8); i += TC_THREADS) {
    const int r = i / (TC_BK / 8), c = i % (TC_BK / 8);
    const int m = m0 + r, k = k0 + 8 * c;
    const int n_el = m < M ? max(0, min(8, K - k)) : 0;
    uint8_t* dst = a_s + c * (TC_BM * 16) + r * 16;
    const __nv_bfloat16* src = x + static_cast<int64_t>(m) * sx + k;
    if (vec_x) {
      cp_async16(dst, n_el ? src : x, 2 * n_el);
    } else {
      __align__(16) __nv_bfloat16 v[8];
#pragma unroll
      for (int e = 0; e < 8; ++e)
        v[e] = e < n_el ? src[e] : __float2bfloat16(0.f);
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(v);
    }
  }
  // w: 16-byte chunks along the unit-stride axis
  constexpr int OUTER = ROWS ? BN : TC_BK;     // rows of the raw tile
  constexpr int INNER = ROWS ? TC_BK : BN;     // bytes per raw row
  for (int i = tid; i < OUTER * (INNER / 16); i += TC_THREADS) {
    const int o = i / (INNER / 16), c = i % (INNER / 16);
    const int go = (ROWS ? n0 : k0) + o;       // n (rows) or k (cols)
    const int gi = (ROWS ? k0 : n0) + 16 * c;  // k (rows) or n (cols)
    const int lim_o = ROWS ? N : K, lim_i = ROWS ? K : N;
    const int nb = go < lim_o ? max(0, min(16, lim_i - gi)) : 0;
    uint8_t* dst = w_s + o * INNER + 16 * c;
    const int8_t* src = w + static_cast<int64_t>(go) * sw + gi;
    if (vec_w) {
      cp_async16(dst, nb ? src : w, nb);
    } else {
      __align__(16) int8_t v[16];
#pragma unroll
      for (int e = 0; e < 16; ++e) v[e] = e < nb ? src[e] : int8_t(0);
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(v);
    }
  }
}

// The stage's raw int8 tile -> bf16 B tile in the K-major core-matrix
// layout: 16-byte chunk (column n, k-chunk c) at c * BN * 16 + n * 16.
template <int BN, bool ROWS>
__device__ __forceinline__ void tc_convert(const uint8_t* w_s, uint8_t* b_s) {
  const int tid = threadIdx.x;
  if constexpr (ROWS) {
    // raw [BN][BK]: a column's 8 k are 8 contiguous bytes; a warp takes 4
    // columns x 8 k-chunks (2-way bank conflicts on both sides)
    for (int i = tid; i < BN * (TC_BK / 8); i += TC_THREADS) {
      const int n = i % 4 + 4 * (i / 32), c = (i / 4) % 8;
      const uint2 raw = *reinterpret_cast<const uint2*>(w_s + n * TC_BK + 8 * c);
      float f[8];
      i8x4_to_f32(raw.x, f);
      i8x4_to_f32(raw.y, f + 4);
      *reinterpret_cast<uint4*>(b_s + c * (BN * 16) + n * 16) =
          make_uint4(pack_bf16(f[0], f[1]), pack_bf16(f[2], f[3]),
                     pack_bf16(f[4], f[5]), pack_bf16(f[6], f[7]));
    }
  } else {
    // raw [BK][BN]: 4 adjacent columns x 8 k from 8 words
    for (int i = tid; i < (BN / 4) * (TC_BK / 8); i += TC_THREADS) {
      const int q = i % (BN / 4), c = i / (BN / 4);
      uint32_t wd[8];
#pragma unroll
      for (int e = 0; e < 8; ++e)
        wd[e] = *reinterpret_cast<const uint32_t*>(w_s + (8 * c + e) * BN + 4 * q) ^
                0x80808080u;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float f[8];
#pragma unroll
        for (int e = 0; e < 8; ++e)
          f[e] = __uint_as_float(__byte_perm(wd[e], 0x4B000000u, 0x7540u | j)) -
                 8388736.f;
        *reinterpret_cast<uint4*>(b_s + c * (BN * 16) + (4 * q + j) * 16) =
            make_uint4(pack_bf16(f[0], f[1]), pack_bf16(f[2], f[3]),
                       pack_bf16(f[4], f[5]), pack_bf16(f[6], f[7]));
      }
    }
  }
}

// y (M, N) f32 = (x @ w8) * scale for bf16 x. Block (m tile, rank) of a
// cluster of `cs` blocks x n tile: 64 x BN outputs over k-tiles [rank *
// kt_per, +kt_per); w8 element (k, n) at k * sw + n (cols) or n * sw + k
// (rows).
template <int BN, bool ROWS>
__global__ void __launch_bounds__(TC_THREADS)
tc_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ w,
          const float* __restrict__ scale, float* __restrict__ y, int M,
          int K, int N, int64_t sx, int64_t sw, int vec_x, int vec_w, int cs,
          int kt_per) {
  using L = TcSmem<BN>;
  extern __shared__ __align__(128) uint8_t tc_smem[];
  uint8_t* b_s = tc_smem + TC_STAGES * L::STAGE;
  const int rank = blockIdx.x % cs;
  const int m0 = (blockIdx.x / cs) * TC_BM;
  const int n0 = blockIdx.y * BN;
  const int kt0 = rank * kt_per;
  const int nk = max(0, min((K + TC_BK - 1) / TC_BK - kt0, kt_per));

  float d[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) d[i] = 0.f;

#pragma unroll
  for (int s = 0; s < TC_STAGES - 1; ++s) {
    if (s < nk)
      tc_load<BN, ROWS>(tc_smem + s * L::STAGE, x, w, M, K, N, sx, sw, m0, n0,
                        kt0 + s, vec_x, vec_w);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<TC_STAGES - 2>();
    __syncthreads();   // tile kt landed; the wgmma of kt - 1 is complete
    const int nxt = kt + TC_STAGES - 1;
    if (nxt < nk)
      tc_load<BN, ROWS>(tc_smem + (nxt % TC_STAGES) * L::STAGE, x, w, M, K, N,
                        sx, sw, m0, n0, kt0 + nxt, vec_x, vec_w);
    cp_async_commit();
    uint8_t* stage = tc_smem + (kt % TC_STAGES) * L::STAGE;
    tc_convert<BN, ROWS>(stage + L::A_BYTES, b_s);
    // generic-proxy writes (and cp.async data) visible to wgmma
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < TC_BK / 16; ++s) {
      const uint64_t da = make_desc(stage + s * 2 * (TC_BM * 16), TC_BM * 16, 128);
      const uint64_t db = make_desc(b_s + s * 2 * (BN * 16), BN * 16, 128);
      wgmma_tile<BN>(d, da, db);
    }
    wgmma_commit();
    wgmma_wait0();
  }
  cp_async_wait<0>();

  // accumulator fragment: warp w owns rows 16w..16w+15; d[4j + {0,1}] =
  // (row l / 4, cols 8j + 2 (l % 4) + {0,1}), d[4j + {2,3}] = row + 8
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = 16 * warp + lane / 4;
  if (cs == 1) {
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = n0 + 8 * j + 2 * (lane % 4);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + row + 8 * h;
        if (m >= M) continue;
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (col + e < N)
            y[static_cast<int64_t>(m) * N + col + e] =
                d[4 * j + 2 * h + e] * scale[col + e];
      }
    }
    return;
  }
  // split K: the cluster's tiles, added in fixed rank order through
  // distributed shared memory (the ring is free now); rank q writes the
  // elements q, q + cs, ... of the 64 x BN tile
  __syncthreads();
  float* part = reinterpret_cast<float*>(tc_smem);   // [TC_BM][BN]
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        part[(row + 8 * h) * BN + 8 * j + 2 * (lane % 4) + e] =
            d[4 * j + 2 * h + e];
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  for (int o = rank + cs * threadIdx.x; o < TC_BM * BN;
       o += cs * TC_THREADS) {
    const int m = m0 + o / BN, n = n0 + o % BN;
    if (m >= M || n >= N) continue;
    y[static_cast<int64_t>(m) * N + n] =
        cluster_sum(cluster, part, o, cs) * scale[n];
  }
  cluster.sync();   // no block leaves while another reads its tile
}

// ------------------------------------------------ launchers

// Once per kernel instantiation: the dynamic shared memory it may ask for
// (above 48 KB needs the attribute) and clusters of up to 16 blocks.
template <typename K>
void configure(K kernel, int smem, bool& done) {
  if (!done) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         smem);
    cudaFuncSetAttribute(kernel,
                         cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    done = true;
  }
}

template <int MB, typename XT>
int launch_splitk(const XT* x, const int8_t* w, const float* scale, float* y,
                  int M, int K, int N, int64_t sx, int64_t sk, int vec,
                  int cs, cudaStream_t stream) {
  auto kernel = splitk_kernel<MB, XT>;
  static bool done = false;
  configure(kernel, static_cast<int>(splitk_smem(MB)), done);
  const int tiles = (N + 15) / 16;
  const int kslice = (K + cs - 1) / cs;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles * cs, (M + MB - 1) / MB, 1);
  cfg.blockDim = dim3(SK_THREADS, 1, 1);
  cfg.dynamicSmemBytes = splitk_smem(MB);
  cfg.stream = stream;
  cudaLaunchAttribute attrs[1];
  attrs[0].id = cudaLaunchAttributeClusterDimension;
  attrs[0].val.clusterDim.x = cs;
  attrs[0].val.clusterDim.y = 1;
  attrs[0].val.clusterDim.z = 1;
  cfg.attrs = attrs;
  cfg.numAttrs = cs > 1 ? 1 : 0;
  return static_cast<int>(cudaLaunchKernelEx(&cfg, kernel, x, w, scale, y, M,
                                             K, N, sx, sk, vec, cs, kslice));
}

template <int MB, typename XT>
int launch_rows(const XT* x, const int8_t* w, const float* scale, float* y,
                int M, int K, int N, int64_t sx, int64_t sn, int vec,
                int n_sm, cudaStream_t stream) {
  const int smem = rows_smem(MB, K);
  if (smem > RW_SMEM_MAX) return static_cast<int>(cudaErrorInvalidValue);
  static bool done = false;
  configure(rows_kernel<MB, XT>, RW_SMEM_MAX, done);
  // as many blocks as fit on the SMs at once (they stride over the
  // columns), so each stages x once
  static int occ_smem = -1, occ = 1;
  if (smem != occ_smem) {
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, rows_kernel<MB, XT>,
                                                  RW_THREADS, smem);
    occ = occ > 0 ? occ : 1;
    occ_smem = smem;
  }
  const int need = (N + RW_CPB - 1) / RW_CPB;
  const int grid = n_sm * occ;
  const dim3 g(need < grid ? need : grid, (M + MB - 1) / MB);
  rows_kernel<MB, XT><<<g, RW_THREADS, smem, stream>>>(x, w, scale, y, M, K,
                                                       N, sx, sn, vec);
  return static_cast<int>(cudaGetLastError());
}

template <int BN, bool ROWS>
int launch_tc(const __nv_bfloat16* x, const int8_t* w, const float* scale,
              float* y, int M, int K, int N, int64_t sx, int64_t sw,
              int vec_x, int vec_w, int cs, cudaStream_t stream) {
  using L = TcSmem<BN>;
  auto kernel = tc_kernel<BN, ROWS>;
  static bool done = false;
  configure(kernel, L::TOTAL, done);
  const int nk = (K + TC_BK - 1) / TC_BK;
  const int kt_per = (nk + cs - 1) / cs;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(((M + TC_BM - 1) / TC_BM) * cs, (N + BN - 1) / BN, 1);
  cfg.blockDim = dim3(TC_THREADS, 1, 1);
  cfg.dynamicSmemBytes = L::TOTAL;
  cfg.stream = stream;
  cudaLaunchAttribute attrs[1];
  attrs[0].id = cudaLaunchAttributeClusterDimension;
  attrs[0].val.clusterDim.x = cs;
  attrs[0].val.clusterDim.y = 1;
  attrs[0].val.clusterDim.z = 1;
  cfg.attrs = attrs;
  cfg.numAttrs = cs > 1 ? 1 : 0;
  return static_cast<int>(cudaLaunchKernelEx(&cfg, kernel, x, w, scale, y, M,
                                             K, N, sx, sw, vec_x, vec_w, cs,
                                             kt_per));
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// Path 1: y (M, N) = (x @ w8) * scale, w8 element (k, n) at k * sk + n.
// mb: rows per block (1, 2, 4, 8); cs: blocks per cluster splitting K
// (1..16).
extern "C" int int8_splitk_launch(const void* x, const void* w8,
                                  const void* scale, void* y, int M, int K,
                                  int N, int64_t sx, int64_t sk, int mb,
                                  int cs, int x_bf16, void* stream) {
  const int8_t* w = static_cast<const int8_t*>(w8);
  const float* sc = static_cast<const float*>(scale);
  float* out = static_cast<float*>(y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cs < 1 || cs > 16) return static_cast<int>(cudaErrorInvalidValue);
  const int vec = aligned16(w) && sk % 16 == 0;
#define SPLITK(MB_)                                                          \
  return x_bf16 ? launch_splitk<MB_>(static_cast<const __nv_bfloat16*>(x), w, \
                                     sc, out, M, K, N, sx, sk, vec, cs, s)    \
                : launch_splitk<MB_>(static_cast<const float*>(x), w, sc, out, \
                                     M, K, N, sx, sk, vec, cs, s)
  switch (mb) {
    case 1: SPLITK(1);
    case 2: SPLITK(2);
    case 4: SPLITK(4);
    case 8: SPLITK(8);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef SPLITK
}

// Path 2: w8 element (k, n) at n * sn + k; mb rows per block (1, 2, 4, 8);
// n_sm: the device's SMs.
extern "C" int int8_rows_launch(const void* x, const void* w8,
                                const void* scale, void* y, int M, int K,
                                int N, int64_t sx, int64_t sn, int mb,
                                int n_sm, int x_bf16, void* stream) {
  const int8_t* w = static_cast<const int8_t*>(w8);
  const float* sc = static_cast<const float*>(scale);
  float* out = static_cast<float*>(y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int vec = aligned16(w) && sn % 16 == 0;
#define ROWS(MB_)                                                           \
  return x_bf16 ? launch_rows<MB_>(static_cast<const __nv_bfloat16*>(x), w, \
                                   sc, out, M, K, N, sx, sn, vec, n_sm, s)  \
                : launch_rows<MB_>(static_cast<const float*>(x), w, sc, out, \
                                   M, K, N, sx, sn, vec, n_sm, s)
  switch (mb) {
    case 1: ROWS(1);
    case 2: ROWS(2);
    case 4: ROWS(4);
    case 8: ROWS(8);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef ROWS
}

// Path 3 (bf16 x): w8 element (k, n) at k * sw + n (rows = 0) or
// n * sw + k (rows = 1); bn: columns per block (64 or 128); cs: blocks
// per cluster splitting K (1..16).
extern "C" int int8_tc_launch(const void* x, const void* w8,
                              const void* scale, void* y, int M, int K,
                              int N, int64_t sx, int64_t sw, int rows,
                              int bn, int cs, void* stream) {
  const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
  const int8_t* w = static_cast<const int8_t*>(w8);
  const float* sc = static_cast<const float*>(scale);
  float* out = static_cast<float*>(y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int vec_x = aligned16(xb) && sx % 8 == 0;
  const int vec_w = aligned16(w) && sw % 16 == 0;
  if (cs < 1 || cs > 16) return static_cast<int>(cudaErrorInvalidValue);
#define TC(BN_)                                                          \
  return rows ? launch_tc<BN_, true>(xb, w, sc, out, M, K, N, sx, sw, vec_x, \
                                     vec_w, cs, s)                         \
              : launch_tc<BN_, false>(xb, w, sc, out, M, K, N, sx, sw,      \
                                      vec_x, vec_w, cs, s)
  if (bn == 64) TC(64);
  if (bn == 128) TC(128);
#undef TC
  return static_cast<int>(cudaErrorInvalidValue);
}

namespace {

template <int MB>
int splitk_report(int x_bf16, int* dynamic, int* static_bytes, int* limit) {
  const int bytes = static_cast<int>(splitk_smem(MB));
  return x_bf16 ? smem_report(splitk_kernel<MB, __nv_bfloat16>, bytes,
                              dynamic, static_bytes, limit)
                : smem_report(splitk_kernel<MB, float>, bytes, dynamic,
                              static_bytes, limit);
}

template <int MB>
int rows_report(int x_bf16, int K, int* dynamic, int* static_bytes,
                int* limit) {
  const int bytes = rows_smem(MB, K);
  return x_bf16 ? smem_report(rows_kernel<MB, __nv_bfloat16>, bytes,
                              dynamic, static_bytes, limit)
                : smem_report(rows_kernel<MB, float>, bytes, dynamic,
                              static_bytes, limit);
}

template <int BN>
int tc_report(int rows, int* dynamic, int* static_bytes, int* limit) {
  return rows ? smem_report(tc_kernel<BN, true>, TcSmem<BN>::TOTAL, dynamic,
                            static_bytes, limit)
              : smem_report(tc_kernel<BN, false>, TcSmem<BN>::TOTAL,
                            dynamic, static_bytes, limit);
}

}  // namespace

// Shared memory of one path's kernel: the dynamic bytes its launcher asks
// for, the static bytes it declares, the device's limit per block. path
// 0 split-K (param = mb, variant = x_bf16), 1 rows (param = mb, variant
// = x_bf16; dynamic bytes at this K), 2 wgmma (param = bn, variant = 1
// for the rows layout).
extern "C" int int8_smem(int path, int param, int variant, int K,
                         int* dynamic, int* static_bytes, int* limit) {
  if (path == 2 && param == 64)
    return tc_report<64>(variant, dynamic, static_bytes, limit);
  if (path == 2 && param == 128)
    return tc_report<128>(variant, dynamic, static_bytes, limit);
#define MB_CASE(MB_)                                                     \
  case MB_:                                                              \
    if (path == 0)                                                       \
      return splitk_report<MB_>(variant, dynamic, static_bytes, limit);  \
    if (path == 1)                                                       \
      return rows_report<MB_>(variant, K, dynamic, static_bytes, limit); \
    break;
  switch (param) {
    MB_CASE(1)
    MB_CASE(2)
    MB_CASE(4)
    MB_CASE(8)
  }
#undef MB_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}
