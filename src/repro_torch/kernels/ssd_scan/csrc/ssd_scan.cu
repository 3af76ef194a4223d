// Mamba2 SSD chunked scan for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `ssd_scan_pallas` of the JAX package
// (src/repro/kernels/ssd_scan/kernel.py, body `_make_ssd_kernel`). For
// one request b and head h (group g = h / (H / G) of B and C):
//
//   state_t = exp(dt_t A_h) state_{t-1} + dt_t x_t B_tᵀ      (P x N, f32)
//   y_t     = state_t C_t
//
// computed chunk by chunk in the dual form: within a chunk of Q tokens
// with cum_i = sum_{k <= i} dt_k A_h,
//
//   y_i   = sum_{j <= i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j
//           + exp(cum_i) state_in C_i
//   state = exp(cum_{Q-1}) state_in
//           + sum_j exp(cum_{Q-1} - cum_j) dt_j x_j B_jᵀ
//
// x (b, L, H, P) and B, C (b, L, G, N), all f32 or all bf16, are read
// through element strides (unit stride along P and N), so the mixer's
// views of its conv output need no copy, and B, C are read per group in
// place (no head broadcast). dt (b, L, H) and A (H,) are f32; the
// initial state (b, H, P, N) f32 may be null (zeros). y (b, L, H, P) is
// written in x's dtype, the final state (b, H, P, N) in f32.
//
// What bounds it on the H100: at prefill (L = 512) the f32 operations
// (mamba2-130m: H = 24, P = 64, N = 128), at decode (L = 1) the bytes of
// the state read and written. This first version does every product
// with f32 FMAs on CUDA cores from shared memory.
//
// What the design does about it:
//   * One block per (request, head). The TPU's sequential chunk axis
//     becomes a loop over chunks inside the block; the state stays in
//     shared memory from the first chunk to the last and touches device
//     memory twice (initial state in, final state out).
//   * The inner chunk Q is the kernel's own (at most 64; the wrapper
//     halves it until the tiles fit): at N = 128 a 128-token f32 chunk
//     (B and C tiles, x, the state and Q x Q scores) would need 265 KB.
//     The function does not depend on Q beyond the order of f32 sums.
//   * The decay exp(cum_i - cum_j) is computed only for i >= j: above the
//     diagonal the exponent is positive and may overflow, and inf x 0
//     would be NaN.
//   * Tokens past L in the last chunk load as dt = 0, x = B = C = 0, so
//     they decay the state by exp(0) = 1 and add nothing; masked tokens
//     (dt = 0 from the caller) do the same.
//   * Shared-memory rows of B, C, the state and the scores are padded by
//     one word, so the strided reads of the dot products fall on distinct
//     banks.
// `wgmma` for the two intra-chunk products, and the state read and
// written in place through the caller's slot indices, are later work.
//
// The C entry point launches on the caller's stream, allocates nothing,
// and returns the first CUDA error (0 on success).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

struct Args {
  const void* x;
  const float* dt;
  const float* A;
  const void* B;
  const void* C;
  const float* init;
  void* y;
  float* final_state;
  int b, L, H, P, G, N, Q;
  int64_t sxb, sxl, sxh;   // x strides (b, l, h); unit along P
  int64_t sdb, sdl, sdh;   // dt strides
  int64_t sbb, sbl, sbg;   // B strides (b, l, g); unit along N
  int64_t scb, scl, scg;   // C strides
};

template <typename XT>
__global__ void __launch_bounds__(THREADS) ssd_scan_kernel(Args a) {
  extern __shared__ float smem[];
  const int h = blockIdx.x;
  const int bi = blockIdx.y;
  const int P = a.P, N = a.N, Q = a.Q;
  const int NP = N + 1, QP = Q + 1;
  float* Bs = smem;              // Q x NP
  float* Cs = Bs + Q * NP;       // Q x NP
  float* Xs = Cs + Q * NP;       // Q x P
  float* Ss = Xs + Q * P;        // P x NP   the carried state
  float* Ms = Ss + P * NP;       // Q x QP   scores, dt_j folded in
  float* dts = Ms + Q * QP;      // Q
  float* cum = dts + Q;          // Q        cumulative dt A
  float* wend = cum + Q;         // Q        exp(cum_last - cum_j) dt_j

  const int tid = threadIdx.x;
  const int g = h / (a.H / a.G);
  const float Ah = a.A[h];
  const XT* x = static_cast<const XT*>(a.x) + bi * a.sxb + h * a.sxh;
  const XT* Bp = static_cast<const XT*>(a.B) + bi * a.sbb + g * a.sbg;
  const XT* Cp = static_cast<const XT*>(a.C) + bi * a.scb + g * a.scg;
  const float* dtp = a.dt + bi * a.sdb + h * a.sdh;
  XT* y = static_cast<XT*>(a.y) + (static_cast<int64_t>(bi) * a.L * a.H + h) * P;
  const int64_t sy = static_cast<int64_t>(a.H) * P;
  const int64_t st_off = (static_cast<int64_t>(bi) * a.H + h) * P * N;

  for (int e = tid; e < P * N; e += THREADS) {
    const int p = e / N, n = e - p * N;
    Ss[p * NP + n] = a.init != nullptr ? a.init[st_off + e] : 0.f;
  }

  for (int t0 = 0; t0 < a.L; t0 += Q) {
    const int nv = min(Q, a.L - t0);   // real tokens in this chunk
    for (int e = tid; e < Q * N; e += THREADS) {
      const int j = e / N, n = e - j * N;
      float bv = 0.f, cv = 0.f;
      if (j < nv) {
        bv = to_f32(Bp[(t0 + j) * a.sbl + n]);
        cv = to_f32(Cp[(t0 + j) * a.scl + n]);
      }
      Bs[j * NP + n] = bv;
      Cs[j * NP + n] = cv;
    }
    for (int e = tid; e < Q * P; e += THREADS) {
      const int j = e / P, p = e - j * P;
      Xs[e] = j < nv ? to_f32(x[(t0 + j) * a.sxl + p]) : 0.f;
    }
    if (tid < Q) dts[tid] = tid < nv ? dtp[(t0 + tid) * a.sdl] : 0.f;
    __syncthreads();
    if (tid == 0) {
      float c = 0.f;
      for (int j = 0; j < Q; ++j) {
        c += dts[j] * Ah;
        cum[j] = c;
      }
    }
    __syncthreads();
    const float cl = cum[Q - 1];
    if (tid < Q) wend[tid] = expf(cl - cum[tid]) * dts[tid];
    // scores: M[i][j] = (C_i . B_j) exp(cum_i - cum_j) dt_j for j <= i
    for (int e = tid; e < Q * Q; e += THREADS) {
      const int i = e / Q, j = e - i * Q;
      float m = 0.f;
      if (j <= i && i < nv) {
        float d = 0.f;
        for (int n = 0; n < N; ++n) d += Cs[i * NP + n] * Bs[j * NP + n];
        m = d * expf(cum[i] - cum[j]) * dts[j];
      }
      Ms[i * QP + j] = m;
    }
    __syncthreads();
    // y_i = sum_j M[i][j] x_j + exp(cum_i) state_in C_i
    for (int e = tid; e < nv * P; e += THREADS) {
      const int i = e / P, p = e - i * P;
      float intra = 0.f;
      for (int j = 0; j <= i; ++j) intra += Ms[i * QP + j] * Xs[j * P + p];
      float inter = 0.f;
      for (int n = 0; n < N; ++n) inter += Cs[i * NP + n] * Ss[p * NP + n];
      store(y + (t0 + i) * sy + p, intra + expf(cum[i]) * inter);
    }
    __syncthreads();
    // state = exp(cum_last) state_in + sum_j wend_j x_j B_jᵀ
    const float dec = expf(cl);
    for (int e = tid; e < P * N; e += THREADS) {
      const int p = e / N, n = e - p * N;
      float s = dec * Ss[p * NP + n];
      for (int j = 0; j < nv; ++j) s += wend[j] * Xs[j * P + p] * Bs[j * NP + n];
      Ss[p * NP + n] = s;
    }
    __syncthreads();
  }

  for (int e = tid; e < P * N; e += THREADS) {
    const int p = e / N, n = e - p * N;
    a.final_state[st_off + e] = Ss[p * NP + n];
  }
}

template <typename XT>
int launch(const Args& a, int smem, cudaStream_t stream) {
  auto kernel = ssd_scan_kernel<XT>;
  static int smem_set = 48 * 1024;   // the default limit without opt-in
  if (smem > smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_set = smem;
  }
  const dim3 grid(a.H, a.b);
  kernel<<<grid, THREADS, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int ssd_scan_launch(
    const void* x, const void* dt, const void* A, const void* B,
    const void* C, const void* init, void* y, void* final_state,
    int b, int L, int H, int P, int G, int N, int Q,
    int64_t sxb, int64_t sxl, int64_t sxh,
    int64_t sdb, int64_t sdl, int64_t sdh,
    int64_t sbb, int64_t sbl, int64_t sbg,
    int64_t scb, int64_t scl, int64_t scg,
    int bf16, int smem_bytes, void* stream) {
  Args a;
  a.x = x;
  a.dt = static_cast<const float*>(dt);
  a.A = static_cast<const float*>(A);
  a.B = B;
  a.C = C;
  a.init = static_cast<const float*>(init);
  a.y = y;
  a.final_state = static_cast<float*>(final_state);
  a.b = b; a.L = L; a.H = H; a.P = P; a.G = G; a.N = N; a.Q = Q;
  a.sxb = sxb; a.sxl = sxl; a.sxh = sxh;
  a.sdb = sdb; a.sdl = sdl; a.sdh = sdh;
  a.sbb = sbb; a.sbl = sbl; a.sbg = sbg;
  a.scb = scb; a.scl = scl; a.scg = scg;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<__nv_bfloat16>(a, smem_bytes, s)
              : launch<float>(a, smem_bytes, s);
}
