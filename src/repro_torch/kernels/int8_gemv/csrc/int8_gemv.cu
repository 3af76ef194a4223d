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
// The Pallas kernel serves B <= 8 rows; this one serves any M: rows are
// tiled in blocks of MB <= 8 (grid.y), so drafter decode (M <= 8) is one
// row block and a 512-row prefill chunk is 64 of them.
//
// What bounds it on the H100: at decode (M <= 8) the weight bytes — one
// byte per weight over the 3.35 TB/s of HBM — since each weight byte
// feeds only 2 M operations; the int8 -> f32 conversion stays in
// registers, so HBM carries one byte per weight, not the four of a
// dequantised copy. Large M (prefill) would be bound by the f32 FMA rate
// of CUDA cores here; a tensor-core int8 path is later work.
//
// What the design does about it:
//   * cols layout: 256 threads = 32 k-groups x 8 column groups; a thread
//     owns 4 adjacent columns and loads them as one 4-byte vector, so the
//     8 lanes of a k-group read 32 contiguous bytes of a weight row and a
//     warp reads 4 full 32-byte sectors per load. Each k-group walks every
//     32nd row of K; the 32 partial sums of a column are then added in
//     k-group order through shared memory. A block covers 32 columns and
//     one row block, so a 128- or 896-column projection at decode fills
//     only 4 or 28 of the 132 SMs (splitting K over more blocks is later
//     work: ROADMAP queue 2 item 3a).
//   * rows layout: a warp owns two columns at a time; its 32 lanes read
//     4 contiguous bytes of each, 128 contiguous bytes of a column per
//     load with two loads in flight, and each column's sum is a shuffle
//     reduction. The row block of x is staged in shared memory as f32
//     once per block and read there as float4, conflict-free, once per
//     two columns; a block covers 128 columns. (Of one, two and four
//     columns at a time, two was the fastest on the card at 4 rows; four
//     costs occupancy.)
// Vector loads are used where the stride is 1 and the addresses are
// 4-byte aligned; otherwise bytes are read one by one.
//
// The C entry point launches on the caller's stream, allocates nothing
// and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
// cols layout
constexpr int C_CG = 8;                 // column groups per block
constexpr int C_CPT = 4;                // columns per thread
constexpr int C_NB = C_CG * C_CPT;      // 32 columns per block
constexpr int C_KG = THREADS / C_CG;    // 32 k-groups
// rows layout
constexpr int R_WARPS = THREADS / 32;   // 8
constexpr int R_CPW = 16;               // columns per warp
constexpr int R_CPI = 2;                // of them in flight at once
constexpr int R_NB = R_WARPS * R_CPW;   // 128 columns per block
constexpr int R_SMEM_MAX = 200 * 1024;  // staged x bytes per block

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ void load4(const int8_t* p, bool vec, int valid,
                                      float (&w)[4]) {
  if (vec && valid >= 4) {
    const char4 c = *reinterpret_cast<const char4*>(p);
    w[0] = static_cast<float>(c.x);
    w[1] = static_cast<float>(c.y);
    w[2] = static_cast<float>(c.z);
    w[3] = static_cast<float>(c.w);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      w[j] = j < valid ? static_cast<float>(p[j]) : 0.f;
  }
}

// w8 element (k, n) at k * sk + n
template <int MB, typename XT>
__global__ void __launch_bounds__(THREADS)
gemv_cols_kernel(const XT* __restrict__ x, const int8_t* __restrict__ w,
                 const float* __restrict__ scale, float* __restrict__ y,
                 int M, int K, int N, int64_t sx, int64_t sk, int vec) {
  __shared__ float red[C_KG][MB][C_NB];
  const int tid = threadIdx.x;
  const int cg = tid % C_CG;
  const int kg = tid / C_CG;
  const int nb = blockIdx.x * C_NB;
  const int n0 = nb + cg * C_CPT;
  const int m0 = blockIdx.y * MB;
  const int valid = min(C_CPT, N - n0);

  float acc[MB][C_CPT];
#pragma unroll
  for (int mi = 0; mi < MB; ++mi)
#pragma unroll
    for (int j = 0; j < C_CPT; ++j) acc[mi][j] = 0.f;

  if (valid > 0) {
    for (int k = kg; k < K; k += C_KG) {
      float wf[C_CPT];
      load4(w + static_cast<int64_t>(k) * sk + n0, vec, valid, wf);
#pragma unroll
      for (int mi = 0; mi < MB; ++mi) {
        const float xv =
            m0 + mi < M ? to_f32(x[static_cast<int64_t>(m0 + mi) * sx + k])
                        : 0.f;
#pragma unroll
        for (int j = 0; j < C_CPT; ++j) acc[mi][j] += xv * wf[j];
      }
    }
  }
#pragma unroll
  for (int mi = 0; mi < MB; ++mi)
#pragma unroll
    for (int j = 0; j < C_CPT; ++j) red[kg][mi][cg * C_CPT + j] = acc[mi][j];
  __syncthreads();
  for (int o = tid; o < MB * C_NB; o += THREADS) {
    const int mi = o / C_NB, c = o % C_NB;
    const int m = m0 + mi, n = nb + c;
    if (m < M && n < N) {
      float s = 0.f;
      for (int g = 0; g < C_KG; ++g) s += red[g][mi][c];
      y[static_cast<int64_t>(m) * N + n] = s * scale[n];
    }
  }
}

// w8 element (k, n) at n * sn + k
template <int MB, typename XT>
__global__ void __launch_bounds__(THREADS)
gemv_rows_kernel(const XT* __restrict__ x, const int8_t* __restrict__ w,
                 const float* __restrict__ scale, float* __restrict__ y,
                 int M, int K, int N, int64_t sx, int64_t sn, int vec) {
  extern __shared__ float4 xs4[];
  float* xs = reinterpret_cast<float*>(xs4);   // [MB][Kp] f32
  const int Kp = (K + 3) & ~3;
  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * MB;
  for (int i = tid; i < MB * Kp; i += THREADS) {
    const int mi = i / Kp, k = i % Kp;
    xs[i] = (m0 + mi < M && k < K)
                ? to_f32(x[static_cast<int64_t>(m0 + mi) * sx + k])
                : 0.f;
  }
  __syncthreads();
  const int warp = tid / 32, lane = tid % 32;
  for (int c0 = 0; c0 < R_CPW; c0 += R_CPI) {
    // this warp's columns: n = tile + (c0 + i) * R_WARPS + warp
    const int nw = blockIdx.x * R_NB + c0 * R_WARPS + warp;
    if (nw >= N) break;   // uniform across the warp
    const int8_t* wc[R_CPI];
    int nc[R_CPI];
#pragma unroll
    for (int i = 0; i < R_CPI; ++i) {
      nc[i] = nw + i * R_WARPS;
      wc[i] = w + static_cast<int64_t>(min(nc[i], N - 1)) * sn;
    }
    float acc[R_CPI][MB];
#pragma unroll
    for (int i = 0; i < R_CPI; ++i)
#pragma unroll
      for (int mi = 0; mi < MB; ++mi) acc[i][mi] = 0.f;
    for (int k0 = lane * 4; k0 < K; k0 += 128) {
      float wf[R_CPI][4];
#pragma unroll
      for (int i = 0; i < R_CPI; ++i)
        load4(wc[i] + k0, vec, min(4, K - k0), wf[i]);
#pragma unroll
      for (int mi = 0; mi < MB; ++mi) {
        const float4 xv = *reinterpret_cast<const float4*>(xs + mi * Kp + k0);
#pragma unroll
        for (int i = 0; i < R_CPI; ++i)
          acc[i][mi] += xv.x * wf[i][0] + xv.y * wf[i][1] + xv.z * wf[i][2] +
                        xv.w * wf[i][3];
      }
    }
#pragma unroll
    for (int i = 0; i < R_CPI; ++i)
#pragma unroll
      for (int mi = 0; mi < MB; ++mi)
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          acc[i][mi] += __shfl_xor_sync(0xffffffffu, acc[i][mi], off);
    if (lane == 0) {
#pragma unroll
      for (int i = 0; i < R_CPI; ++i) {
        if (nc[i] >= N) continue;
        const float sc = scale[nc[i]];
#pragma unroll
        for (int mi = 0; mi < MB; ++mi)
          if (m0 + mi < M)
            y[static_cast<int64_t>(m0 + mi) * N + nc[i]] = acc[i][mi] * sc;
      }
    }
  }
}

template <int MB, typename XT>
int launch(const void* x, const int8_t* w, const float* scale, float* y,
           int M, int K, int N, int64_t sx, int64_t sk, int64_t sn,
           cudaStream_t stream) {
  const dim3 block(THREADS);
  const int mblocks = (M + MB - 1) / MB;
  const uintptr_t wa = reinterpret_cast<uintptr_t>(w);
  if (sn == 1) {
    const int vec = (wa % 4 == 0) && (sk % 4 == 0);
    const dim3 grid((N + C_NB - 1) / C_NB, mblocks);
    gemv_cols_kernel<MB, XT><<<grid, block, 0, stream>>>(
        static_cast<const XT*>(x), w, scale, y, M, K, N, sx, sk, vec);
  } else if (sk == 1) {
    const int vec = (wa % 4 == 0) && (sn % 4 == 0);
    const size_t smem = static_cast<size_t>(MB) * ((K + 3) & ~3) * 4;
    if (smem > R_SMEM_MAX) return static_cast<int>(cudaErrorInvalidValue);
    static bool attr_set = false;   // one flag per instantiation
    if (!attr_set) {
      cudaFuncSetAttribute(gemv_rows_kernel<MB, XT>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           R_SMEM_MAX);
      attr_set = true;
    }
    const dim3 grid((N + R_NB - 1) / R_NB, mblocks);
    gemv_rows_kernel<MB, XT><<<grid, block, smem, stream>>>(
        static_cast<const XT*>(x), w, scale, y, M, K, N, sx, sn, vec);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename XT>
int dispatch_rows(const void* x, const int8_t* w, const float* scale,
                  float* y, int M, int K, int N, int64_t sx, int64_t sk,
                  int64_t sn, int mb, cudaStream_t s) {
#define INT8_GEMV_LAUNCH(MB_) \
  return launch<MB_, XT>(x, w, scale, y, M, K, N, sx, sk, sn, s)
  switch (mb) {
    case 1: INT8_GEMV_LAUNCH(1);
    case 2: INT8_GEMV_LAUNCH(2);
    case 4: INT8_GEMV_LAUNCH(4);
    case 8: INT8_GEMV_LAUNCH(8);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef INT8_GEMV_LAUNCH
}

}  // namespace

// y (M, N) f32 = (x @ w8) * scale. x: (M, K) with row stride sx and unit
// stride along K; w8 element (k, n) at k * sk + n * sn with sk == 1 or
// sn == 1; scale: N contiguous f32; mb: rows per block (1, 2, 4 or 8).
extern "C" int int8_gemv_launch(const void* x, const void* w8,
                                const void* scale, void* y, int M, int K,
                                int N, int64_t sx, int64_t sk, int64_t sn,
                                int mb, int x_bf16, void* stream) {
  const int8_t* w = static_cast<const int8_t*>(w8);
  const float* sc = static_cast<const float*>(scale);
  float* out = static_cast<float*>(y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16)
    return dispatch_rows<__nv_bfloat16>(x, w, sc, out, M, K, N, sx, sk, sn,
                                        mb, s);
  return dispatch_rows<float>(x, w, sc, out, M, K, N, sx, sk, sn, mb, s);
}
