// Flash-attention partials for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `flash_attention_partial` of the JAX
// package (src/repro/kernels/common.py, body `_make_kernel`): blocked
// online-softmax attention that returns the UNNORMALISED partials
// (acc, m, l), so that several key sources (the slot cache and a freshly
// drafted tree segment) can be merged exactly before the normalisation.
// Keys are masked by k_pos >= 0, by causality (k_pos <= q_pos), by an
// optional window (q_pos - k_pos < window) and by an optional bool mask;
// a masked key scores NEG_INF = -1e30 and contributes p = 0, so a fully
// masked row leaves l = 0 (the merge turns that into an output of 0).
//
// What bounds it on the H100: the serving shapes are decode (one token,
// G = 7 query rows per KV head), tree verification (~10 tokens) and
// prefill chunks (up to 512 tokens). For decode and verification every
// byte of K and V of the active slots is read once for a handful of
// query rows, so the kernel is bound by the K/V bytes it reads over the
// 3.35 TB/s of HBM; only the 512-row prefill has enough rows per key to
// approach the float32 FMA rate.
//
// What the design does about it: K/V are read in place from the resident
// slot pool through `slot_idx` (no gathered copy, which would read and
// write every byte once more), in their stored dtype (f32 or bf16) with
// the conversion to f32 done on the way into shared memory. A key tile
// whose positions no query row of the block can see (empty slots past a
// request's length, keys above the causal diagonal, keys out of the
// window) is skipped after reading only its 32 positions, so a request
// reads the K/V of the tokens it holds, not the slot's capacity. One thread
// block owns (request, KV head, tile of 16 query rows) and walks the keys
// in tiles of 32 staged in shared memory, so every K/V byte is read once
// per 16 query rows; all GQA rows of a head share that tile. The running
// max, sum and the f32 accumulator stay in registers across the key loop
// (the Pallas kernel's VMEM scratch and sequential K grid axis become a
// loop inside the block). This first version uses CUDA cores in f32,
// not wgmma; splitting K across blocks for decode is left for later.
//
// The C entry point launches on the caller's stream, allocates nothing
// and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int ROWS = 16;            // query rows per block
constexpr int KT = 32;              // keys per shared-memory tile
constexpr int TPR = 8;              // threads per query row
constexpr int THREADS = ROWS * TPR; // 128
constexpr int KPT = KT / TPR;       // keys scored per thread per tile
constexpr float NEG_INF = -1e30f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const int32_t* q_pos;
  const int32_t* k_pos;
  const uint8_t* mask;
  const int32_t* slot_idx;
  float* acc;
  float* m;
  float* l;
  int T, G, H, S;
  // element strides
  int64_t q_sb, q_st, q_sh, q_sg;
  int64_t k_sp, k_ss, k_sh;
  int64_t v_sp, v_ss, v_sh;
  int64_t kpos_sp, qpos_sb;
  int64_t mask_sb, mask_st;
  float scale;
  int causal;
  int window;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <int D, typename QT, typename KVT>
__global__ void __launch_bounds__(THREADS)
fa_partial_kernel(const Params p) {
  constexpr int DPT = D / TPR;  // accumulator columns per thread
  // +1 pads break the bank conflicts of the row-strided dot products
  __shared__ float q_s[ROWS][D + 1];
  __shared__ float k_s[KT][D + 1];
  __shared__ float v_s[KT][D];
  __shared__ float p_s[ROWS][KT + 1];
  __shared__ int32_t kpos_s[KT];
  __shared__ int32_t qpos_s[ROWS];

  const int R = p.T * p.G;
  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int r0 = blockIdx.x * ROWS;
  const int tid = threadIdx.x;
  const int row = tid / TPR;
  const int lane = tid % TPR;
  const int r = r0 + row;
  const bool row_ok = r < R;
  const int t = row_ok ? r / p.G : 0;
  const int slot = p.slot_idx ? p.slot_idx[b] : b;

  // query tile -> shared memory as f32 (rows past R are zeros)
  const QT* qb = static_cast<const QT*>(p.q) + b * p.q_sb + h * p.q_sh;
  for (int i = tid; i < ROWS * D; i += THREADS) {
    const int rr = i / D, d = i % D, ri = r0 + rr;
    float x = 0.f;
    if (ri < R) {
      x = to_f32(qb[(ri / p.G) * p.q_st + (ri % p.G) * p.q_sg + d]);
    }
    q_s[rr][d] = x;
  }
  const int qpos = row_ok ? p.q_pos[b * p.qpos_sb + t] : 0;
  if (lane == 0) qpos_s[row] = qpos;
  const uint8_t* mrow =
      (p.mask != nullptr && row_ok) ? p.mask + b * p.mask_sb + t * p.mask_st
                                    : nullptr;

  const KVT* kb = static_cast<const KVT*>(p.k) + slot * p.k_sp + h * p.k_sh;
  const KVT* vb = static_cast<const KVT*>(p.v) + slot * p.v_sp + h * p.v_sh;
  const int32_t* kp = p.k_pos + slot * p.kpos_sp;

  float acc[DPT];
#pragma unroll
  for (int i = 0; i < DPT; ++i) acc[i] = 0.f;
  float m_run = NEG_INF;
  float l_run = 0.f;

  // the block's query-position range, to skip key tiles no row can see
  __syncthreads();
  int qmin = 2147483647, qmax = -2147483647 - 1;
  for (int i = 0; i < ROWS && r0 + i < R; ++i) {
    qmin = min(qmin, qpos_s[i]);
    qmax = max(qmax, qpos_s[i]);
  }

  for (int s0 = 0; s0 < p.S; s0 += KT) {
    __syncthreads();  // the previous tile is consumed (and q_s is staged)
    int live = 0;
    if (tid < KT) {
      const int s = s0 + tid;
      const int kpos = s < p.S ? kp[s] : -1;
      kpos_s[tid] = kpos;
      live = kpos >= 0 && (!p.causal || kpos <= qmax) &&
             (p.window <= 0 || qmin - kpos < p.window);
    }
    // A tile where no row can see any key changes nothing (every p = 0 and
    // the correction is exp(0) = 1), so it is skipped without reading K/V.
    if (!__syncthreads_or(live)) continue;
    for (int i = tid; i < KT * D; i += THREADS) {
      const int j = i / D, d = i % D, s = s0 + j;
      float kx = 0.f, vx = 0.f;
      if (s < p.S) {
        kx = to_f32(kb[s * p.k_ss + d]);
        vx = to_f32(vb[s * p.v_ss + d]);
      }
      k_s[j][d] = kx;
      v_s[j][d] = vx;
    }
    __syncthreads();

    float sc[KPT];
    bool ok[KPT];
    float tmax = NEG_INF;
#pragma unroll
    for (int i = 0; i < KPT; ++i) {
      const int j = lane + TPR * i;
      float dot = 0.f;
#pragma unroll 16
      for (int d = 0; d < D; ++d) dot += q_s[row][d] * k_s[j][d];
      const int kpos = kpos_s[j];
      bool valid = row_ok && kpos >= 0;
      if (p.causal) valid = valid && kpos <= qpos;
      if (p.window > 0) valid = valid && (qpos - kpos < p.window);
      if (mrow != nullptr) valid = valid && mrow[s0 + j] != 0;
      sc[i] = valid ? dot * p.scale : NEG_INF;
      ok[i] = valid;
      tmax = fmaxf(tmax, sc[i]);
    }
    // the TPR lanes of a row are adjacent lanes of one warp
#pragma unroll
    for (int off = TPR / 2; off > 0; off >>= 1)
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, off));
    const float m_new = fmaxf(m_run, tmax);
    float psum = 0.f;
#pragma unroll
    for (int i = 0; i < KPT; ++i) {
      const float pv = ok[i] ? expf(sc[i] - m_new) : 0.f;
      p_s[row][lane + TPR * i] = pv;
      psum += pv;
    }
#pragma unroll
    for (int off = TPR / 2; off > 0; off >>= 1)
      psum += __shfl_xor_sync(0xffffffffu, psum, off);
    const float corr = expf(m_run - m_new);
    l_run = l_run * corr + psum;
    m_run = m_new;
    __syncwarp();  // p_s of this row is written by lanes of this warp

#pragma unroll
    for (int i = 0; i < DPT; ++i) acc[i] *= corr;
    for (int j = 0; j < KT; ++j) {
      const float pj = p_s[row][j];
#pragma unroll
      for (int i = 0; i < DPT; ++i) acc[i] += pj * v_s[j][lane + TPR * i];
    }
  }

  if (row_ok) {
    const int g = r % p.G;
    const int64_t o = ((static_cast<int64_t>(b) * p.T + t) * p.H + h) * p.G + g;
#pragma unroll
    for (int i = 0; i < DPT; ++i) p.acc[o * D + lane + TPR * i] = acc[i];
    if (lane == 0) {
      p.m[o] = m_run;
      p.l[o] = l_run;
    }
  }
}

template <int D, typename QT, typename KVT>
void launch(const Params& p, int B, cudaStream_t stream) {
  const int R = p.T * p.G;
  dim3 grid((R + ROWS - 1) / ROWS, p.H, B);
  fa_partial_kernel<D, QT, KVT><<<grid, THREADS, 0, stream>>>(p);
}

template <int D>
int dispatch_dtypes(const Params& p, int B, int q_bf16, int kv_bf16,
                    cudaStream_t stream) {
  if (q_bf16 && kv_bf16) launch<D, __nv_bfloat16, __nv_bfloat16>(p, B, stream);
  else if (q_bf16) launch<D, __nv_bfloat16, float>(p, B, stream);
  else if (kv_bf16) launch<D, float, __nv_bfloat16>(p, B, stream);
  else launch<D, float, float>(p, B, stream);
  return 0;
}

}  // namespace

extern "C" int fa_partial_launch(
    const void* q, const void* k, const void* v, const void* q_pos,
    const void* k_pos, const void* mask, const void* slot_idx, void* acc,
    void* m, void* l, int B, int T, int G, int H, int S, int D,
    int64_t q_sb, int64_t q_st, int64_t q_sh, int64_t q_sg, int64_t k_sp,
    int64_t k_ss, int64_t k_sh, int64_t v_sp, int64_t v_ss, int64_t v_sh,
    int64_t kpos_sp, int64_t qpos_sb, int64_t mask_sb, int64_t mask_st,
    float scale, int causal, int window, int q_bf16, int kv_bf16,
    void* stream) {
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.q_pos = static_cast<const int32_t*>(q_pos);
  p.k_pos = static_cast<const int32_t*>(k_pos);
  p.mask = static_cast<const uint8_t*>(mask);
  p.slot_idx = static_cast<const int32_t*>(slot_idx);
  p.acc = static_cast<float*>(acc);
  p.m = static_cast<float*>(m);
  p.l = static_cast<float*>(l);
  p.T = T;
  p.G = G;
  p.H = H;
  p.S = S;
  p.q_sb = q_sb;
  p.q_st = q_st;
  p.q_sh = q_sh;
  p.q_sg = q_sg;
  p.k_sp = k_sp;
  p.k_ss = k_ss;
  p.k_sh = k_sh;
  p.v_sp = v_sp;
  p.v_ss = v_ss;
  p.v_sh = v_sh;
  p.kpos_sp = kpos_sp;
  p.qpos_sb = qpos_sb;
  p.mask_sb = mask_sb;
  p.mask_st = mask_st;
  p.scale = scale;
  p.causal = causal;
  p.window = window;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: dispatch_dtypes<16>(p, B, q_bf16, kv_bf16, s); break;
    case 32: dispatch_dtypes<32>(p, B, q_bf16, kv_bf16, s); break;
    case 64: dispatch_dtypes<64>(p, B, q_bf16, kv_bf16, s); break;
    case 128: dispatch_dtypes<128>(p, B, q_bf16, kv_bf16, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
