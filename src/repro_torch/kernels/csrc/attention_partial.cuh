// Online-softmax attention partials for Hopper (sm_90a): the kernel body
// shared by `flash_attention/csrc/flash_attention.cu` (keys of a resident
// slot pool, read through `slot_idx`) and
// `paged_attention/csrc/paged_attention.cu` (keys of a page pool, read
// through a block table). Each of those files instantiates it for its
// own key addressing and has its own C entry point.
//
// It returns the UNNORMALISED partials (acc, m, l), so that several key
// sources (the cache and a freshly drafted tree segment) can be merged
// exactly before the normalisation. Keys are masked by k_pos >= 0, by
// causality (k_pos <= q_pos), by an optional window (q_pos - k_pos <
// window) and by an optional bool mask; a masked key scores NEG_INF =
// -1e30 and contributes p = 0, so a fully masked row leaves l = 0.
//
// One thread block owns (request, KV head, tile of 16 query rows) and
// walks the request's logical keys in tiles of 32 staged in shared memory
// as f32 (K/V are read in their stored dtype, f32 or bf16); every K/V
// byte is read once per 16 query rows, and all GQA rows of a head share
// the tile. The running max, sum and the f32 accumulator stay in
// registers across the key loop. A key tile whose positions no query row
// of the block can see (empty slots, unmapped or NULL pages, keys above
// the causal diagonal or out of the window) is skipped after reading
// only its 32 positions: that is bit-exact (every p = 0 and the
// correction is exp(0) = 1).
//
// Key addressing is the one difference between the two instantiations:
// logical key s of request b lives in pool row (page, row) =
//   resident: (slot_idx[b] or b, s)
//   paged:    (block_table[b, s / page_size], s % page_size)
// and the tile loop is otherwise the same code, so a page pool read
// through its block table gives bit for bit the partials of the resident
// kernel over the gathered view (the same tiles in the same order).

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace attn_partial {

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
  const int32_t* k_pos;        // (pool rows, S) positions, -1 = empty
  const uint8_t* mask;         // optional (B, T, S) bool
  const int32_t* slot_idx;     // resident: pool row of request b (or null)
  const int32_t* block_table;  // paged: (B, n_view) physical page ids
  float* acc;
  float* m;
  float* l;
  int T, G, H, S;              // S = logical keys per request
  int page_size;               // paged: keys per page
  // element strides
  int64_t q_sb, q_st, q_sh, q_sg;
  int64_t k_sp, k_ss, k_sh;    // pool row (slot or page), key, head
  int64_t v_sp, v_ss, v_sh;
  int64_t kpos_sp, qpos_sb;
  int64_t mask_sb, mask_st;
  int64_t bt_sb;
  float scale;
  int causal;
  int window;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <int D, typename QT, typename KVT, bool PAGED>
__global__ void __launch_bounds__(THREADS)
partial_kernel(const Params p) {
  constexpr int DPT = D / TPR;  // accumulator columns per thread
  // +1 pads break the bank conflicts of the row-strided dot products
  __shared__ float q_s[ROWS][D + 1];
  __shared__ float k_s[KT][D + 1];
  __shared__ float v_s[KT][D];
  __shared__ float p_s[ROWS][KT + 1];
  __shared__ int32_t kpos_s[KT];
  __shared__ int64_t koff_s[PAGED ? KT : 1];   // paged: key rows' offsets
  __shared__ int64_t voff_s[PAGED ? KT : 1];
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
  const int slot = PAGED ? 0 : (p.slot_idx ? p.slot_idx[b] : b);
  const int32_t* btab = PAGED ? p.block_table + b * p.bt_sb : nullptr;
  // resident: the request's pool row; paged: offsets come per key
  const int32_t* kp = p.k_pos + (PAGED ? 0 : slot * p.kpos_sp);

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

  const KVT* kb = static_cast<const KVT*>(p.k) + h * p.k_sh +
                 (PAGED ? 0 : slot * p.k_sp);
  const KVT* vb = static_cast<const KVT*>(p.v) + h * p.v_sh +
                 (PAGED ? 0 : slot * p.v_sp);

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
      int kpos = -1;
      if (s < p.S) {
        if constexpr (PAGED) {
          const int64_t pg = btab[s / p.page_size];
          const int rw = s % p.page_size;
          kpos = kp[pg * p.kpos_sp + rw];
          koff_s[tid] = pg * p.k_sp + rw * p.k_ss;
          voff_s[tid] = pg * p.v_sp + rw * p.v_ss;
        } else {
          kpos = kp[s];
        }
      }
      kpos_s[tid] = kpos;
      live = kpos >= 0 && (!p.causal || kpos <= qmax) &&
             (p.window <= 0 || qmin - kpos < p.window);
    }
    // A tile where no row can see any key changes nothing (every p = 0 and
    // the correction is exp(0) = 1), so it is skipped without reading K/V.
    if (!__syncthreads_or(live)) continue;
    for (int i = tid; i < KT * D; i += THREADS) {
      const int j = i / D, d = i % D;
      float kx = 0.f, vx = 0.f;
      const int s = s0 + j;
      if (s < p.S) {
        if constexpr (PAGED) {
          kx = to_f32(kb[koff_s[j] + d]);
          vx = to_f32(vb[voff_s[j] + d]);
        } else {
          kx = to_f32(kb[s * p.k_ss + d]);
          vx = to_f32(vb[s * p.v_ss + d]);
        }
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

template <int D, typename QT, typename KVT, bool PAGED>
void launch(const Params& p, int B, cudaStream_t stream) {
  const int R = p.T * p.G;
  dim3 grid((R + ROWS - 1) / ROWS, p.H, B);
  partial_kernel<D, QT, KVT, PAGED><<<grid, THREADS, 0, stream>>>(p);
}

template <int D, bool PAGED>
void dispatch_dtypes(const Params& p, int B, int q_bf16, int kv_bf16,
                     cudaStream_t stream) {
  if (q_bf16 && kv_bf16)
    launch<D, __nv_bfloat16, __nv_bfloat16, PAGED>(p, B, stream);
  else if (q_bf16)
    launch<D, __nv_bfloat16, float, PAGED>(p, B, stream);
  else if (kv_bf16)
    launch<D, float, __nv_bfloat16, PAGED>(p, B, stream);
  else
    launch<D, float, float, PAGED>(p, B, stream);
}

// Launch on `stream` for head dim D in {16, 32, 64, 128}; returns
// cudaGetLastError() (cudaErrorInvalidValue for another D).
template <bool PAGED>
int dispatch(const Params& p, int B, int D, int q_bf16, int kv_bf16,
             cudaStream_t stream) {
  switch (D) {
    case 16: dispatch_dtypes<16, PAGED>(p, B, q_bf16, kv_bf16, stream); break;
    case 32: dispatch_dtypes<32, PAGED>(p, B, q_bf16, kv_bf16, stream); break;
    case 64: dispatch_dtypes<64, PAGED>(p, B, q_bf16, kv_bf16, stream); break;
    case 128: dispatch_dtypes<128, PAGED>(p, B, q_bf16, kv_bf16, stream); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace attn_partial
