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
// Four kernels share the key addressing, the split and the merge, chosen
// by the head widths (Dk, Dv), the K/V storage and R, the query rows of
// one (request, KV head) (`ops.py::tiling`, from these alone):
//   * `partial_kernel`, Dk == Dv in {16, 32, 64, 120, 128}: GQA heads
//     with f32 or bf16 K/V below `ops.py::R_MMA` rows (decode and the
//     other few-row reads), 16 rows a block on CUDA cores. Described
//     below.
//   * `rows_kernel`, the many-row form: the same heads at D 64, 120 and
//     128 with f32 or bf16 K/V from R_MMA rows (prefill chunks, commits,
//     cache passes and segments at G 4, cross reads of a frontend
//     prefill, the Whisper encoder): 64 rows a block share each key tile,
//     both products on tensor cores (3xTF32 / bf16 `mma.sync`): see the
//     comment above `rows_kernel`.
//   * `int8_kernel`, the same heads (D 120 included) with int8 K/V and an
//     f32 scale per (row, head) (`kv_dtype="int8"` caches): a ring of
//     int8 tiles in flight, each tile converted once to bf16 in shared
//     memory by the warps that read it, both products on tensor cores,
//     16 or 64 query rows a block: see the comment above `int8_kernel`.
//   * `latent_kernel`, Dk != Dv: MLA's absorbed attention (DeepSeek-V3:
//     one KV head holding c_kv ++ k_pe, Dk = 512 + 64 = 576, Dv = 512,
//     all 128 query heads folded onto it as G = 128 rows a token), and a
//     tiny pair (40, 32) for tests; f32 or bf16 K/V and q. 64 query rows
//     a block share each key tile, V is read out of K's tile when `v` is
//     K's first Dv columns, and both products run on tensor cores: see
//     the comment above `latent_kernel`.
//
// What bounds the GQA form on the H100: at decode and the other reads of
// a handful of query rows per KV head it reads each K/V byte of the keys
// a request holds once for a few rows: bound by those bytes over 3.35
// TB/s, a few microseconds, so latency decides — how many blocks share
// the keys and how many round trips to HBM each block waits for. Reads of
// many rows a KV head are bound by their products and go to the many-row
// form (`R_MMA`, measured: from R = 17, where this form needs a second
// 16-row block per key tile).
//
// What the design does about it:
//   * Split-K (flash-decoding). A cluster of `n_split` blocks owns
//     (request, KV head, tile of 16 query rows). The LOGICAL keys are cut
//     into spans of `span_tiles` whole key tiles and block `i` walks
//     spans i, i + n_split, ... in order: one contiguous range whenever S
//     fits n_split spans, as at the serving shapes. The wrapper
//     (`ops.py::plan_splits`) fixes the span from the grid alone (B, Hkv,
//     rows) and n_split from S and the span, never from the live lengths,
//     so no host sync. Each block's partial (m, l, acc) goes to shared
//     memory and the cluster merges the n_split partials in fixed rank
//     order through distributed shared memory (`map_shared_rank` after
//     `cluster.sync()`) with the arithmetic of `merge_partials`; each
//     rank merges and writes its share of the rows. A block with no live
//     key contributes (NEG_INF, 0, 0), which the merge passes through
//     exactly (x * exp(0) + 0), so two pools of other capacities (a
//     resident slot pool, a page pool's view) that hold the same keys
//     give the same bits. n_split <= 16 (16 is above the portable
//     cluster size of 8).
//   * Pipelined tiles. K/V tiles are staged in their stored dtype (f32
//     or bf16) with 16-byte `cp.async` copies into a double buffer, so the
//     copy of tile t + 1 overlaps the arithmetic of tile t; values become
//     f32 where they are used. A tile's key positions (and, paged, its
//     rows' page offsets) are read two tiles ahead (the block-table entry
//     three ahead), so each tile's copy is issued before the previous
//     tile is computed. A tile whose positions no query row of the block
//     can see (empty slots, unmapped or NULL pages, keys above the causal
//     diagonal or out of the window) is not copied at all
//     (`__syncthreads_or`): a request reads only the K/V it holds, and
//     skipping is bit-exact (every p = 0, the correction exp(0) = 1).
//   * f32 on CUDA cores. TPR = 8 threads share a query row; each keeps
//     its strip of Dk/TPR of q in registers and scores every key of a
//     tile over that strip (one shared-memory read per
//     FMA, broadcast to the warp's rows), then a fixed butterfly over the
//     row's lanes hands each lane the full dot products of KT/TPR keys.
//     Strips are interleaved in chunks of up to 16 bytes (lane + TPR c),
//     so a row's reads cover contiguous bytes. At D = 120 (h2o-danube3)
//     a strip is 15 values, so its chunks are single values (q and acc
//     in 15 scalar registers a thread), while a key row stays a whole
//     number of 16-byte copies (480 B at f32, 240 at bf16). That is the
//     right shape where a block has a handful of rows; with hundreds a
//     KV head each staged key would be read again by every 16-row block
//     and no tensor core used, which is why those reads go to
//     `rows_kernel`.
//
// Key addressing is the one difference between the two instantiations:
// logical key s of request b lives in pool row (page, row) =
//   resident: (slot_idx[b] or b, s)
//   paged:    (block_table[b, s / page_size], s % page_size)
// and the tile loop, the split and the merge are otherwise the same code,
// so a page pool read through its block table gives bit for bit the
// partials of the resident kernel over the gathered view (the same tiles,
// split the same way, in the same order).

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

#include "smem_report.cuh"

namespace attn_partial {

namespace cg = cooperative_groups;

constexpr int ROWS = 16;            // query rows per block (GQA form)
constexpr int META = 3;             // tiles of key metadata in flight
constexpr float NEG_INF = -1e30f;

// The tiling of the GQA form for head widths (D, D): see the top of the
// file. `ops.py::tiling` mirrors KT and MAX_SPLIT.
template <int DK, int DV>
struct Form {
  static_assert(DK == DV, "the Dk != Dv form is LatentForm");
  static constexpr int KT = 32;                      // keys per tile
  static constexpr int TPR = 8;                      // threads per row
  static constexpr int THREADS = ROWS * TPR;
  static constexpr int KPT = KT / TPR;               // keys per lane
  static constexpr int MAX_SPLIT = 16;               // blocks a cluster
  static_assert(KT % TPR == 0 && KT % 4 == 0 && 32 % TPR == 0, "tiling");
};

// Values per chunk of a thread's strip: the largest power of two of at
// most 16 bytes that divides the strip (dpt values).
__host__ __device__ constexpr int chunk_vals(int dpt, int max_vals) {
  int c = max_vals;
  while (dpt % c != 0) c /= 2;
  return c;
}

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const int32_t* q_pos;
  const int32_t* k_pos;        // (pool rows, S) positions, -1 = empty
  const uint8_t* mask;         // optional (B, T, S) bool
  const int32_t* slot_idx;     // resident: pool row of request b (or null)
  const int32_t* block_table;  // paged: (B, n_view) physical page ids
  const float* k_scale;        // int8 K/V: (pool rows, S, H) f32 scales
  const float* v_scale;
  float* acc;
  float* m;
  float* l;
  int T, G, H, S;              // S = logical keys per request
  int page_size;               // paged: keys per page
  int n_split;                 // blocks per (b, h, row tile): a cluster
  int span_tiles;              // key tiles per span of the key split
  // element strides
  int64_t q_sb, q_st, q_sh, q_sg;
  int64_t k_sp, k_ss, k_sh;    // pool row (slot or page), key, head
  int64_t v_sp, v_ss, v_sh;
  int64_t ksc_sp, ksc_ss, ksc_sh;   // int8 K/V: the scales' strides
  int64_t vsc_sp, vsc_ss, vsc_sh;
  int64_t kpos_sp, qpos_sb;
  int64_t mask_sb, mask_st;
  int64_t bt_sb;
  float scale;
  int causal;
  int window;
  int v_in_k;                  // latent form: v is K's first Dv columns
                               // (same base and strides): V is read out
                               // of K's tile (`ops.py::v_in_k`)
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// CV consecutive values of a shared-memory row as f32 (CV * sizeof(T)
// <= 16 bytes, aligned)
template <int CV>
__device__ __forceinline__ void lds(const float* p, float (&o)[CV]) {
  if constexpr (CV == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    o[0] = t.x; o[1] = t.y; o[2] = t.z; o[3] = t.w;
  } else if constexpr (CV == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    o[0] = t.x; o[1] = t.y;
  } else {
#pragma unroll
    for (int e = 0; e < CV; ++e) o[e] = p[e];
  }
}
template <int CV>
__device__ __forceinline__ void lds(const __nv_bfloat16* p, float (&o)[CV]) {
  if constexpr (CV == 1) {
    o[0] = __bfloat162float(*p);
  } else {
    uint32_t u[CV / 2];
    if constexpr (CV == 8) {
      const uint4 t = *reinterpret_cast<const uint4*>(p);
      u[0] = t.x; u[1] = t.y; u[2] = t.z; u[3] = t.w;
    } else if constexpr (CV == 4) {
      const uint2 t = *reinterpret_cast<const uint2*>(p);
      u[0] = t.x; u[1] = t.y;
    } else {
      u[0] = *reinterpret_cast<const uint32_t*>(p);
    }
#pragma unroll
    for (int i = 0; i < CV / 2; ++i) {
      o[2 * i] = __uint_as_float(u[i] << 16);
      o[2 * i + 1] = __uint_as_float(u[i] & 0xFFFF0000u);
    }
  }
}

// One level of the butterfly that sums a row's partial dots over its
// lanes, then the next: lanes with bit OFF keep the upper HALF of their
// keys and add their partner's, so each level halves the keys a lane
// holds (all indices fixed at compile time: `part` stays in registers).
template <int HALF, int OFF, int N>
__device__ __forceinline__ void butterfly(float (&part)[N], int lane) {
  if constexpr (OFF > 0) {
    const bool up = lane & OFF;
#pragma unroll
    for (int i2 = 0; i2 < HALF; ++i2) {
      const float send = up ? part[i2] : part[i2 + HALF];
      const float keep = up ? part[i2 + HALF] : part[i2];
      part[i2] = keep + __shfl_xor_sync(0xffffffffu, send, OFF);
    }
    butterfly<HALF / 2, OFF / 2>(part, lane);
  }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int bytes) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(bytes));
}

// an 8-byte copy (an int8 row of 120 bytes is 8-byte aligned only)
__device__ __forceinline__ void cp_async8(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
               "l"(gmem));
}

// One key's metadata, read by thread `j` (< KT) of the block: position
// and pool-row offsets of K and V (element offsets from the head's base).
struct KeyMeta {
  int32_t pos;
  int64_t koff, voff;
};

template <int DK, int DV, typename QT, typename KVT, bool PAGED>
__global__ void __launch_bounds__(Form<DK, DV>::THREADS)
partial_kernel(const Params p) {
  using F = Form<DK, DV>;
  constexpr int KT = F::KT, TPR = F::TPR, THREADS = F::THREADS;
  constexpr int KPT = F::KPT, MAX_SPLIT = F::MAX_SPLIT;
  static_assert(!std::is_same<KVT, int8_t>::value,
                "int8 K/V is int8_kernel's");
  constexpr int CVK = chunk_vals(DK / TPR, 16 / int(sizeof(KVT)));
  constexpr int NCHK = DK / TPR / CVK;               // q chunks per thread
  constexpr int CVV = chunk_vals(DV / TPR, 16 / int(sizeof(KVT)));
  constexpr int NCHV = DV / TPR / CVV;               // acc chunks
  constexpr int TILE_K = KT * DK;                    // elements per tile
  constexpr int TILE_V = KT * DV;
  constexpr int CPK = DK * int(sizeof(KVT)) / 16;    // 16 B copies a key
  constexpr int CPV = DV * int(sizeof(KVT)) / 16;

  extern __shared__ __align__(16) uint8_t kv_smem[];
  KVT* kv_s = reinterpret_cast<KVT*>(kv_smem);       // [2][K, V][KT][D]
  __shared__ int32_t kpos_s[META][KT];
  __shared__ int64_t koff_s[PAGED ? META : 1][KT];
  __shared__ int64_t voff_s[PAGED ? META : 1][KT];
  __shared__ __align__(16) float p_s[ROWS][KT];
  __shared__ float mrg_m[ROWS], mrg_l[ROWS];

  const int R = p.T * p.G;
  const int rank = blockIdx.x % p.n_split;
  const int r0 = (blockIdx.x / p.n_split) * ROWS;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int row = tid / TPR;
  const int lane = tid % TPR;
  const int r = r0 + row;
  const bool row_ok = r < R;
  const int t = row_ok ? r / p.G : 0;
  const int slot = PAGED ? 0 : (p.slot_idx ? p.slot_idx[b] : b);
  const int32_t* btab = PAGED ? p.block_table + b * p.bt_sb : nullptr;
  const int32_t* kp = p.k_pos + (PAGED ? 0 : slot * p.kpos_sp);
  const KVT* kb = static_cast<const KVT*>(p.k) + h * p.k_sh +
                  (PAGED ? 0 : slot * p.k_sp);
  const KVT* vb = static_cast<const KVT*>(p.v) + h * p.v_sh +
                  (PAGED ? 0 : slot * p.v_sp);

  // this block's tiles: spans rank, rank + n_split, ... of span_tiles
  // tiles; only the last span of all may be short
  const int n_tiles = (p.S + KT - 1) / KT;
  const int span = p.span_tiles;
  int nt = 0;
  for (int j = rank; j * span < n_tiles; j += p.n_split)
    nt += min(span, n_tiles - j * span);
  auto tile_of = [&](int i) {
    return (rank + p.n_split * (i / span)) * span + i % span;
  };

  // this thread's strip of q: chunk c covers d = (lane + TPR c) * CVK + e
  float qr[NCHK][CVK];
  {
    const QT* qrow = static_cast<const QT*>(p.q) + b * p.q_sb + h * p.q_sh +
                     (row_ok ? t * p.q_st + (r % p.G) * p.q_sg : 0);
#pragma unroll
    for (int c = 0; c < NCHK; ++c)
#pragma unroll
      for (int e = 0; e < CVK; ++e)
        qr[c][e] = row_ok ? to_f32(qrow[(lane + TPR * c) * CVK + e]) : 0.f;
  }
  const int qpos = row_ok ? p.q_pos[b * p.qpos_sb + t] : 0;
  const uint8_t* mrow =
      (p.mask != nullptr && row_ok) ? p.mask + b * p.mask_sb + t * p.mask_st
                                    : nullptr;

  // warp 0 tests tiles for live keys: the block's query-position range
  int qmin = 2147483647, qmax = -2147483647 - 1;
  if (tid < 32) {
    if (tid < ROWS && r0 + tid < R) {
      const int qp = p.q_pos[b * p.qpos_sb + (r0 + tid) / p.G];
      qmin = qp;
      qmax = qp;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      qmin = min(qmin, __shfl_xor_sync(0xffffffffu, qmin, off));
      qmax = max(qmax, __shfl_xor_sync(0xffffffffu, qmax, off));
    }
  }
  auto live_key = [&](int32_t kpos) {
    return kpos >= 0 && (!p.causal || kpos <= qmax) &&
           (p.window <= 0 || qmin - kpos < p.window);
  };

  // key metadata of tile i of this split, for thread tid < KT. Paged:
  // `page` is the tile's key's physical page, read one step earlier.
  auto block_page = [&](int i) -> int32_t {
    const int s = tile_of(i) * KT + tid;
    return (i < nt && s < p.S) ? btab[s / p.page_size] : 0;
  };
  auto load_meta = [&](int i, int32_t page) -> KeyMeta {
    KeyMeta km{-1, 0, 0};
    const int s = tile_of(i) * KT + tid;
    if (i < nt && s < p.S) {
      // the pool row (slot or page) and the row within it
      const int64_t prow = PAGED ? page : slot;
      const int64_t rw = PAGED ? s % p.page_size : s;
      if constexpr (PAGED) {
        km.pos = kp[prow * p.kpos_sp + rw];
        km.koff = prow * p.k_sp + rw * p.k_ss;
        km.voff = prow * p.v_sp + rw * p.v_ss;
      } else {
        km.pos = kp[s];
      }
    }
    return km;
  };
  auto store_meta = [&](int i, const KeyMeta& km) {
    kpos_s[i % META][tid] = km.pos;
    if constexpr (PAGED) {
      koff_s[i % META][tid] = km.koff;
      voff_s[i % META][tid] = km.voff;
    }
  };
  // issue the copies of tile i (its metadata is in slot i % META): a key's
  // K and V rows side by side, CPM 16-byte parts each (the shorter row
  // skips its missing parts)
  auto copy_tile = [&](int i) {
    KVT* ks = kv_s + (i & 1) * (TILE_K + TILE_V);
    KVT* vs = ks + TILE_K;
    const int s0 = tile_of(i) * KT;
    constexpr int EPC = 16 / int(sizeof(KVT));     // elements per copy
    constexpr int CPM = CPK > CPV ? CPK : CPV;
    for (int c = tid; c < KT * CPM; c += THREADS) {
      const int j = c / CPM, part = c % CPM, e0 = part * EPC;
      const int s = s0 + j;
      const bool in = s < p.S;
      int64_t ko, vo;
      if constexpr (PAGED) {
        ko = koff_s[i % META][j];
        vo = voff_s[i % META][j];
      } else {
        ko = static_cast<int64_t>(s) * p.k_ss;
        vo = static_cast<int64_t>(s) * p.v_ss;
      }
      if (part < CPK)
        cp_async16(ks + j * DK + e0, in ? kb + ko + e0 : kb, in ? 16 : 0);
      if (part < CPV)
        cp_async16(vs + j * DV + e0, in ? vb + vo + e0 : vb, in ? 16 : 0);
    }
  };

  float acc[NCHV][CVV];
#pragma unroll
  for (int c = 0; c < NCHV; ++c)
#pragma unroll
    for (int e = 0; e < CVV; ++e) acc[c][e] = 0.f;
  float m_run = NEG_INF;
  float l_run = 0.f;

  // prologue: metadata of tiles 0 and 1, the copy of tile 0
  int32_t page_next = 0;   // paged: block-table entry of tile i + 2
  int live0 = 0, live1 = 0;
  if (tid < KT) {
    int32_t pg0 = 0, pg1 = 0;
    if constexpr (PAGED) {
      pg0 = block_page(0);
      pg1 = block_page(1);
      page_next = block_page(2);
    }
    const KeyMeta a = load_meta(0, pg0), c1 = load_meta(1, pg1);
    store_meta(0, a);
    store_meta(1, c1);
    live0 = 0 < nt && live_key(a.pos);
    live1 = 1 < nt && live_key(c1.pos);
  }
  int cur_live = __syncthreads_or(live0);
  int next_live = __syncthreads_or(live1);
  if (cur_live) copy_tile(0);
  asm volatile("cp.async.commit_group;\n" ::);

  for (int i = 0; i < nt; ++i) {
    // the copy of tile i + 1 (its buffer was consumed at step i - 1)
    if (next_live) copy_tile(i + 1);
    asm volatile("cp.async.commit_group;\n" ::);
    // metadata of tile i + 2 (and the page of tile i + 3) in flight
    KeyMeta ahead{-1, 0, 0};
    if (tid < KT) {
      ahead = load_meta(i + 2, page_next);
      if constexpr (PAGED) page_next = block_page(i + 3);
    }
    asm volatile("cp.async.wait_group 1;\n" ::);
    __syncthreads();

    if (cur_live) {
      const KVT* ks = kv_s + (i & 1) * (TILE_K + TILE_V);
      const KVT* vs = ks + TILE_K;
      const int32_t* kpos_t = kpos_s[i % META];
      const int s0 = tile_of(i) * KT;
      // partial dots of all KT keys over this thread's strip
      float part[KT];
#pragma unroll
      for (int j = 0; j < KT; ++j) {
        float dot = 0.f;
#pragma unroll
        for (int c = 0; c < NCHK; ++c) {
          float kf[CVK];
          lds<CVK>(ks + j * DK + (lane + TPR * c) * CVK, kf);
#pragma unroll
          for (int e = 0; e < CVK; ++e) dot += qr[c][e] * kf[e];
        }
        part[j] = dot;
      }
      // butterfly over the row's TPR lanes: lane keeps keys KPT * lane + i
      butterfly<KT / 2, TPR / 2>(part, lane);
      float sc[KPT];
      bool ok[KPT];
      float tmax = NEG_INF;
#pragma unroll
      for (int i2 = 0; i2 < KPT; ++i2) {
        const int j = KPT * lane + i2;
        const int kpos = kpos_t[j];
        bool valid = row_ok && kpos >= 0;
        if (p.causal) valid = valid && kpos <= qpos;
        if (p.window > 0) valid = valid && (qpos - kpos < p.window);
        if (mrow != nullptr) valid = valid && s0 + j < p.S && mrow[s0 + j] != 0;
        sc[i2] = valid ? part[i2] * p.scale : NEG_INF;
        ok[i2] = valid;
        tmax = fmaxf(tmax, sc[i2]);
      }
      // the TPR lanes of a row are adjacent lanes of one warp
#pragma unroll
      for (int off = TPR / 2; off > 0; off >>= 1)
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, off));
      const float m_new = fmaxf(m_run, tmax);
      float pv[KPT];
      float psum = 0.f;
#pragma unroll
      for (int i2 = 0; i2 < KPT; ++i2) {
        pv[i2] = ok[i2] ? expf(sc[i2] - m_new) : 0.f;
        psum += pv[i2];
      }
      if constexpr (KPT == 4) {
        *reinterpret_cast<float4*>(&p_s[row][KPT * lane]) =
            make_float4(pv[0], pv[1], pv[2], pv[3]);
      } else {
#pragma unroll
        for (int i2 = 0; i2 < KPT; ++i2) p_s[row][KPT * lane + i2] = pv[i2];
      }
#pragma unroll
      for (int off = TPR / 2; off > 0; off >>= 1)
        psum += __shfl_xor_sync(0xffffffffu, psum, off);
      const float corr = expf(m_run - m_new);
      l_run = l_run * corr + psum;
      m_run = m_new;
      __syncwarp();  // p_s of this row is written by lanes of this warp

#pragma unroll
      for (int c = 0; c < NCHV; ++c)
#pragma unroll
        for (int e = 0; e < CVV; ++e) acc[c][e] *= corr;
#pragma unroll 4
      for (int j4 = 0; j4 < KT; j4 += 4) {
        const float4 p4 = *reinterpret_cast<const float4*>(&p_s[row][j4]);
        const float pj[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
          for (int c = 0; c < NCHV; ++c) {
            float vf[CVV];
            lds<CVV>(vs + (j4 + jj) * DV + (lane + TPR * c) * CVV, vf);
#pragma unroll
            for (int e = 0; e < CVV; ++e) acc[c][e] += pj[jj] * vf[e];
          }
        }
      }
    }

    // metadata of tile i + 2 lands; every thread is done with buffer i & 1
    int live2 = 0;
    if (tid < KT) {
      store_meta(i + 2, ahead);
      live2 = i + 2 < nt && live_key(ahead.pos);
    }
    const int l2 = __syncthreads_or(live2);
    cur_live = next_live;
    next_live = l2;
  }
  asm volatile("cp.async.wait_group 0;\n" ::);

  const int64_t o = row_ok
      ? ((static_cast<int64_t>(b) * p.T + t) * p.H + h) * p.G + r % p.G
      : 0;
  if (p.n_split == 1) {
    if (row_ok) {
#pragma unroll
      for (int c = 0; c < NCHV; ++c)
#pragma unroll
        for (int e = 0; e < CVV; ++e)
          p.acc[o * DV + (lane + TPR * c) * CVV + e] = acc[c][e];
      if (lane == 0) {
        p.m[o] = m_run;
        p.l[o] = l_run;
      }
    }
    return;
  }

  // merge the cluster's n_split partials in rank order (merge_partials'
  // arithmetic); the K/V buffer is free now and holds this block's acc
  __syncthreads();
  float* mrg_acc = reinterpret_cast<float*>(kv_smem);   // [ROWS][DV]
#pragma unroll
  for (int c = 0; c < NCHV; ++c)
#pragma unroll
    for (int e = 0; e < CVV; ++e)
      mrg_acc[row * DV + (lane + TPR * c) * CVV + e] = acc[c][e];
  if (lane == 0) {
    mrg_m[row] = m_run;
    mrg_l[row] = l_run;
  }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  for (int e = rank * THREADS + tid; e < ROWS * DV; e += p.n_split * THREADS) {
    const int rr = e / DV, d = e % DV;
    const int ri = r0 + rr;
    if (ri >= R) continue;
    // every remote load in flight before the fold
    float mq[MAX_SPLIT], lq[MAX_SPLIT], aq[MAX_SPLIT];
#pragma unroll
    for (int q = 0; q < MAX_SPLIT; ++q) {
      const bool in = q < p.n_split;
      mq[q] = in ? cluster.map_shared_rank(mrg_m, q)[rr] : NEG_INF;
      lq[q] = in ? cluster.map_shared_rank(mrg_l, q)[rr] : 0.f;
      aq[q] = in ? cluster.map_shared_rank(mrg_acc, q)[rr * DV + d] : 0.f;
    }
    float m_a = mq[0], l_a = lq[0], a_a = aq[0];
#pragma unroll
    for (int q = 1; q < MAX_SPLIT; ++q) {
      if (q < p.n_split) {
        const float mm = fmaxf(m_a, mq[q]);
        const float ea = expf(m_a - mm), eb = expf(mq[q] - mm);
        l_a = l_a * ea + lq[q] * eb;
        a_a = a_a * ea + aq[q] * eb;
        m_a = mm;
      }
    }
    const int ti = ri / p.G;
    const int64_t oi =
        ((static_cast<int64_t>(b) * p.T + ti) * p.H + h) * p.G + ri % p.G;
    p.acc[oi * DV + d] = a_a;
    if (d == 0) {
      p.m[oi] = m_a;
      p.l[oi] = l_a;
    }
  }
  cluster.sync();   // no block leaves while another reads its partials
}

// the double-buffered staging tiles
template <int DK, int DV, typename KVT>
constexpr int kv_smem_bytes() {
  constexpr int KT = Form<DK, DV>::KT;
  return 2 * KT * (DK + DV) * int(sizeof(KVT));
}

template <int DK, int DV, typename QT, typename KVT, bool PAGED>
int launch(const Params& p, int B, cudaStream_t stream) {
  using F = Form<DK, DV>;
  if (p.n_split > F::MAX_SPLIT)
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = partial_kernel<DK, DV, QT, KVT, PAGED>;
  constexpr int smem = kv_smem_bytes<DK, DV, KVT>();
  static bool attr = false;   // one flag per instantiation
  if (!attr) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         smem);
    cudaFuncSetAttribute(kernel,
                         cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    attr = true;
  }
  const int R = p.T * p.G;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(((R + ROWS - 1) / ROWS) * p.n_split, p.H, B);
  cfg.blockDim = dim3(F::THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attrs[1];
  attrs[0].id = cudaLaunchAttributeClusterDimension;
  attrs[0].val.clusterDim.x = p.n_split;
  attrs[0].val.clusterDim.y = 1;
  attrs[0].val.clusterDim.z = 1;
  cfg.attrs = attrs;
  cfg.numAttrs = p.n_split > 1 ? 1 : 0;
  return static_cast<int>(cudaLaunchKernelEx(&cfg, kernel, p));
}

// =====================================================================
// The latent form (Dk != Dv): MLA's absorbed attention
// =====================================================================
//
// One KV head holds c_kv ++ k_pe (Dk = 576 at DeepSeek-V3's widths) and
// every query head reads it: a token is G = 128 query rows over the same
// keys, and V is c_kv, the first Dv = 512 columns of K (the model passes
// `v = k[..., :Dv]`). The function is the GQA form's: partials (m, l,
// acc) over the given k and v, under the same masks, split and merge.
//
// What bounds it on the H100. Per key a request holds, K is 576 values
// and each of a token's 128 rows does 2 x (576 + 512) operations on it:
// about 120 operations a byte at f32, 240 at bf16, so decode,
// verification and commit (1-10 tokens) are bound by the latent bytes
// only if a tile is read once for all of a token's rows, and the T = 512
// prefill by the operations. A first design (16 rows a block, K and V
// staged separately, scalar f32 FMAs on CUDA cores, one shared-memory read
// per 1-4 FMAs) read the cache 8 times a token at decode and ran at 9-73x
// its bound, slower than SDPA at the prefill. This one is bound, per
// 16-key tile, by its tensor-core products and the arithmetic that feeds
// them: a 64-row f32 tile issues 3264 `mma.sync` (1088 products, three
// TF32 passes each), and the TF32 splits of its operands share their
// issue slots; a bf16 tile issues 1088 bf16 `mma.sync`, and its copies'
// issue, the softmax and four block barriers weigh as much as the
// products. At decode the cluster merge and the q load add to a few
// tiles on the critical path.
//
// What this design does about it:
//   * 64 rows share a tile. A block owns 64 query rows (half a token's
//     heads at G = 128) and stages each 16-key tile of K once for all of
//     them, so decode reads each held key twice per (request, split), and
//     the T = 10 cache pass and the T = 6 commit walk the cache with 20
//     and 12 row tiles a request, not 80 and 48. q (64 x 576) is staged
//     once per block in shared memory, in its own dtype. The f32 budget
//     decides the shape: q 148,480 B + two 16-key K tiles 74,240 + the
//     score tiles 8,192 + static ~1.4 KB fit the 232,448 B of a block;
//     128 rows or 32-key tiles would not. One block an SM, 16 warps.
//   * V out of K's tile. When `v_in_k` (same base and strides, Dv <= Dk:
//     `ops.py::v_in_k`), only K is copied, double-buffered, and P·V reads
//     its first Dv columns: half the bytes of a K and a V tile. A `v` that
//     is not K's (a snapshot, a gathered view, random inputs) is staged in
//     the second buffer instead, single-buffered beside a single K buffer:
//     K(i + 1) is copied while P·V(i) runs and V(i + 1) while Q·Kᵀ(i + 1)
//     runs. The arithmetic reads the same values in the same order either
//     way, so aliased and non-aliased inputs that hold the same values give
//     bitwise equal partials.
//   * Tensor cores, `mma.sync` with f32 accumulation. f32 K/V:
//     m16n8k8 TF32; an f32 operand is split into a TF32 high part and its
//     residual by one bit mask and a product is taken as hi·hi + lo·hi +
//     hi·lo (3xTF32, to about 2^-19, as `ssd_scan.cu`; bf16 q is exact in
//     TF32, so its residual product is skipped). bf16 K/V: m16n8k16 bf16
//     at twice the depth; K and V are exact, f32 q and P are split into
//     two bf16 halves (about 2^-17), so each product is two; V's
//     fragments come transposed from `ldmatrix`. Why not `wgmma`: TF32
//     `wgmma` needs both operands K-major, V stored key-major is not
//     K-major for P·V, and 3xTF32 would need split copies of q and K in
//     shared memory, which the f32 budget above has no room for; the
//     bf16 products are left to ROADMAP 2d. `mma.sync` loads fragments
//     from registers in any layout and takes the tiny pair's k = 40 (five
//     8-deep TF32 steps; bf16 pads q and K with zeros to 48).
//     Warp layout: Q·Kᵀ gives warp w the 16 rows 16 (w % 4) and all 16
//     keys over a quarter of the k-steps (w / 4); quarters 2 and 3 store
//     their sums to the two score tiles, then quarters 0 and 1 add theirs
//     (S = (q0 + q2) + (q1 + q3), a fixed order). Softmax runs on 8
//     threads a row. P·V gives warp w 32 rows and 64 columns (Dv 512), so
//     each V fragment serves two row tiles (64 accumulator registers a
//     thread; no spill at f32).
//   * Conflict-free fragments at one address register. Staged rows are
//     padded to 16 bytes past a multiple of 128 (32 for f32 q read in
//     pairs), so every fragment load of a warp (q and K along k, V down a
//     column at keys 2t and 2t + 1, where P's k order is permuted so that
//     a thread's two P values sit side by side; `ldmatrix`'s 8 rows)
//     touches distinct banks at a fixed offset from one base.
//   * Bulk copies. q and each K or V tile are staged by `cp.async.bulk`,
//     one key row a warp, completing on an mbarrier per buffer, in place
//     of 2304 16-byte `cp.async` copies a tile whose issue every warp
//     waited on.
//   * Everything else is the GQA form's: the split plan from the grid
//     alone, the cluster merge through distributed shared memory (each
//     row's fold factors computed once), tiles with no live key for the
//     block's rows neither copied nor computed (and passed with one
//     barrier), metadata two tiles ahead, softmax, masks and NEG_INF as
//     before (a fully masked row keeps l = 0).
//
// What is left (ROADMAP 2d): `wgmma` for the bf16 products, a leaner f32
// path, and dropping the MLA cache's "v" leaf.

// The latent form's tiling (`ops.py::tiling` mirrors KT, MAX_SPLIT and
// ROWS).
template <int DK, int DV>
struct LatentForm {
  static constexpr int ROWS = 64;                 // query rows per block
  static constexpr int KT = 16;                   // keys per tile
  static constexpr int WARPS = 16;
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int MAX_SPLIT = 8;             // blocks a cluster
  static constexpr int KSTEPS = DK / 8;           // 8-deep steps of Q·Kᵀ
  static constexpr int KQ = (KSTEPS + 3) / 4;     // Q·Kᵀ: steps a k-quarter
  static constexpr int MR = DV % 64 == 0 ? 2 : 1; // P·V: 16-row tiles a warp
  static constexpr int RG = ROWS / 16 / MR;       // P·V: row groups
  static constexpr int CG = WARPS / RG;           // P·V: column groups
  static constexpr int VN = DV / CG / 8;          // P·V: 8-wide n-tiles
  static constexpr int SPT = THREADS / ROWS;      // softmax threads a row
  static_assert(DK % 8 == 0 && DV % (8 * CG) == 0 && DV < DK,
                "latent widths");
  static_assert(KT % SPT == 0 && SPT <= 32, "softmax lanes");
};

// Row pitch, in elements of T, of a staged row of d values: padded so
// that a row is SKEW bytes past a multiple of 128 (32 banks). SKEW 16 puts
// the 8 rows of a 4-byte fragment load 4 banks apart and the rows 2t and
// 2t + 1 of a V fragment 8 apart, and gives `ldmatrix` 8 rows in distinct
// banks; SKEW 32 puts the rows of an 8-byte load (f32 q in bf16 pairs) 8
// banks apart. Every fragment load is conflict-free and is one base
// register plus an immediate offset.
template <typename T, int SKEW = 16>
__host__ __device__ constexpr int latent_pitch(int d) {
  return d +
         ((SKEW - d * int(sizeof(T))) % 128 + 128) % 128 / int(sizeof(T));
}
// Staged row widths: bf16 K is read 16 values a step (`mma` m16n8k16),
// so its rows and q's are padded with zeros to a multiple of 16
template <int DK, typename KVT>
__host__ __device__ constexpr int latent_dk() {
  return std::is_same<KVT, __nv_bfloat16>::value ? (DK + 15) / 16 * 16 : DK;
}
template <int DK, typename QT, typename KVT>
__host__ __device__ constexpr int latent_q_pitch() {
  return latent_pitch<QT, std::is_same<KVT, __nv_bfloat16>::value &&
                                  std::is_same<QT, float>::value
                              ? 32
                              : 16>(latent_dk<DK, KVT>());
}

// Dynamic shared memory of a latent block: q, two tile buffers, the two
// partial score tiles (then P); at least the merge's (ROWS, DV) f32 rows
// and fold factors, which reuse it after the key loop.
// `ops.py::kernel_smem` mirrors it.
template <int DK, int DV, typename QT, typename KVT>
struct LatentSmem {
  using F = LatentForm<DK, DV>;
  static constexpr int Q =
      F::ROWS * latent_q_pitch<DK, QT, KVT>() * int(sizeof(QT));
  static constexpr int KV = 2 * F::KT *
                            latent_pitch<KVT>(latent_dk<DK, KVT>()) *
                            int(sizeof(KVT));
  static constexpr int SP = 2 * F::ROWS * F::KT * 4;
  // the merge: each block's (ROWS, DV) f32 rows, then each row's factors
  // of the fold over ranks
  static constexpr int MERGE = F::ROWS * DV * 4 + F::ROWS * F::MAX_SPLIT * 8;
  static constexpr int BYTES = Q + KV + SP > MERGE ? Q + KV + SP : MERGE;
};

// a staged value as the bits of an f32 (bf16: exact, in the high half)
__device__ __forceinline__ uint32_t ld_bits(const float* p) {
  return __float_as_uint(*p);
}
__device__ __forceinline__ uint32_t ld_bits(const __nv_bfloat16* p) {
  return static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(p)) << 16;
}

// v = hi + lo in TF32: hi is v with the 13 low mantissa bits cleared
// (a bit mask, not `cvt.rna.tf32`: the conversion unit's rate), lo the
// exact residual v - hi, of which the tensor core reads the top 19 bits as
// of any TF32 operand (hi + lo carries 21 bits of v's 24, products good to
// about 2^-19). An EXACT value (bf16) is its own high part.
constexpr uint32_t TF32_MASK = 0xffffe000u;
template <bool EXACT>
__device__ __forceinline__ void tf32_split(uint32_t v, uint32_t& hi,
                                           uint32_t& lo) {
  if (EXACT) {
    hi = v;
    lo = 0u;
  } else {
    hi = v & TF32_MASK;
    lo = __float_as_uint(__uint_as_float(v) - __uint_as_float(hi));
  }
}

// d += a b, m16n8k8 TF32 with f32 accumulation. Fragments (g = lane / 4,
// t = lane % 4): A a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8,
// t + 4); B b0 (k t, n g), b1 (k t + 4, n g); D d0 (g, 2t), d1 (g, 2t +
// 1), d2 (g + 8, 2t), d3 (g + 8, 2t + 1).
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a b, m16n8k16 bf16 with f32 accumulation. Fragments (g, t as
// above; each register two bf16, the lower k in the low half): A a0 (g,
// 2t..2t+1), a1 (g + 8, 2t..), a2 (g, 2t + 8..), a3 (g + 8, 2t + 8..); B
// b0 (k 2t..2t+1, n g), b1 (k 2t + 8.., n g); D as m16n8k8.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
// the B fragment of keys 0-15 of an 8-column slice of a row-major bf16
// tile, transposed on the way: lane l names row l % 16 (`row` points at
// that row's first column of the slice)
__device__ __forceinline__ void ldmatrix_b(uint32_t (&b)[2],
                                           const __nv_bfloat16* row) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(b[0]), "=r"(b[1])
      : "r"(static_cast<uint32_t>(__cvta_generic_to_shared(row))));
}
// two values as bf16 pairs hi + lo (an f32 pair: hi rounded to bf16, lo
// the rounded residual, together about 2^-17 of each value; a bf16 pair:
// itself, lo zero)
__device__ __forceinline__ void bf16_pair(float x, float y, uint32_t& hi,
                                          uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x - __low2float(h),
                                                 y - __high2float(h));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}
__device__ __forceinline__ void bf16_pair(const float* p, uint32_t& hi,
                                          uint32_t& lo) {
  const float2 v = *reinterpret_cast<const float2*>(p);
  bf16_pair(v.x, v.y, hi, lo);
}
__device__ __forceinline__ void bf16_pair(const __nv_bfloat16* p,
                                          uint32_t& hi, uint32_t& lo) {
  hi = *reinterpret_cast<const uint32_t*>(p);
  lo = 0u;
}

// Bulk copies (the TMA engine without a tensor map): one thread copies a
// whole row of `bytes` (a multiple of 16, both ends 16-byte aligned) into
// shared memory and the copy completes on an mbarrier that expects the
// tile's bytes; threads wait on the barrier's phase parity. A buffer is
// refilled only after a block barrier that follows its last reads (no
// generic-proxy write precedes an async write of the same bytes, so no
// proxy fence is needed).
__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar)));
}
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(smem_u32(bar)), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred done;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n}\n" ::"r"(smem_u32(bar)), "r"(parity) : "memory");
}
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

template <int DK, int DV, typename QT, typename KVT, bool PAGED>
__global__ void __launch_bounds__(LatentForm<DK, DV>::THREADS, 1)
latent_kernel(const Params p) {
  using F = LatentForm<DK, DV>;
  using SM = LatentSmem<DK, DV, QT, KVT>;
  constexpr int ROWS = F::ROWS, KT = F::KT, THREADS = F::THREADS;
  constexpr int KSTEPS = F::KSTEPS, VN = F::VN, MAX_SPLIT = F::MAX_SPLIT;
  constexpr bool QEX = std::is_same<QT, __nv_bfloat16>::value;
  constexpr bool KEX = std::is_same<KVT, __nv_bfloat16>::value;
  constexpr int DKS = latent_dk<DK, KVT>();       // staged K width
  constexpr int QP = latent_q_pitch<DK, QT, KVT>();   // q row pitch
  constexpr int KP = latent_pitch<KVT>(DKS);      // K row pitch
  constexpr int VP = latent_pitch<KVT>(DV);       // V row pitch (own tile)

  extern __shared__ __align__(16) uint8_t lsm[];
  QT* q_s = reinterpret_cast<QT*>(lsm);                        // [ROWS][QP]
  KVT* buf_s = reinterpret_cast<KVT*>(lsm + SM::Q);           // [2][KT][KP]
  float* sp_s = reinterpret_cast<float*>(lsm + SM::Q + SM::KV);
  // sp_s: [2][ROWS][KT] partial scores of the two k-halves; P in half 0
  __shared__ int32_t kpos_s[META][KT];
  __shared__ int32_t ktile_s[META];                   // tile_of(i)
  __shared__ int32_t kpage_s[PAGED ? META : 1][KT];   // paged: the key's
  __shared__ int32_t krow_s[PAGED ? META : 1][KT];    // page and its row
  __shared__ float corr_s[ROWS];
  __shared__ float mrg_m[ROWS], mrg_l[ROWS];
  __shared__ __align__(8) uint64_t bar_s[3];   // tile buffers 0, 1; q

  const int R = p.T * p.G;
  const int rank = blockIdx.x % p.n_split;
  const int r0 = (blockIdx.x / p.n_split) * ROWS;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g8 = lane >> 2, t4 = lane & 3;        // fragment coordinates
  const int rg = warp & 3;                        // Q·Kᵀ: its 16 rows
  const int kq = warp >> 2;                       // Q·Kᵀ: its k-quarter
  constexpr int MR = F::MR, RG = F::RG, CG = F::CG;
  const int prow = 16 * MR * (warp % RG);         // P·V: its 16 MR rows
  const int pcol = (warp / RG) * (DV / CG);       // P·V: its DV / CG columns
  const bool alias = p.v_in_k != 0;
  const int slot = PAGED ? 0 : (p.slot_idx ? p.slot_idx[b] : b);
  const int32_t* btab = PAGED ? p.block_table + b * p.bt_sb : nullptr;
  const int32_t* kp = p.k_pos + (PAGED ? 0 : slot * p.kpos_sp);
  const KVT* kb = static_cast<const KVT*>(p.k) + h * p.k_sh +
                  (PAGED ? 0 : slot * p.k_sp);
  const KVT* vb = static_cast<const KVT*>(p.v) + h * p.v_sh +
                  (PAGED ? 0 : slot * p.v_sp);

  // this block's tiles: spans rank, rank + n_split, ... of span_tiles
  // tiles (as partial_kernel)
  const int n_tiles = (p.S + KT - 1) / KT;
  const int span = p.span_tiles;
  int nt = 0;
  for (int j = rank; j * span < n_tiles; j += p.n_split)
    nt += min(span, n_tiles - j * span);
  auto tile_of = [&](int i) {
    return (rank + p.n_split * (i / span)) * span + i % span;
  };

  // softmax: SPT threads a row, KT / SPT keys of a tile each
  constexpr int SPT = F::SPT, SKEYS = KT / SPT;
  const int srow = tid / SPT, sq = tid % SPT;
  const int sr = r0 + srow;
  const bool srow_ok = sr < R;
  const int st = srow_ok ? sr / p.G : 0;
  const int qpos = srow_ok ? p.q_pos[b * p.qpos_sb + st] : 0;
  const uint8_t* mrow =
      (p.mask != nullptr && srow_ok) ? p.mask + b * p.mask_sb + st * p.mask_st
                                     : nullptr;

  // warp 0 tests tiles for live keys: the block's query-position range
  int qmin = 2147483647, qmax = -2147483647 - 1;
  if (warp == 0) {
#pragma unroll
    for (int rr = lane; rr < ROWS; rr += 32) {
      if (r0 + rr < R) {
        const int qp = p.q_pos[b * p.qpos_sb + (r0 + rr) / p.G];
        qmin = min(qmin, qp);
        qmax = max(qmax, qp);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      qmin = min(qmin, __shfl_xor_sync(0xffffffffu, qmin, off));
      qmax = max(qmax, __shfl_xor_sync(0xffffffffu, qmax, off));
    }
  }
  auto live_key = [&](int32_t kpos) {
    return kpos >= 0 && (!p.causal || kpos <= qmax) &&
           (p.window <= 0 || qmin - kpos < p.window);
  };

  // key metadata of tile i, for thread tid < KT (as partial_kernel)
  auto block_page = [&](int i) -> int32_t {
    const int s = tile_of(i) * KT + tid;
    return (i < nt && s < p.S) ? btab[s / p.page_size] : 0;
  };
  auto load_meta = [&](int i, int32_t page) -> KeyMeta {
    KeyMeta km{-1, 0, 0};
    const int s = tile_of(i) * KT + tid;
    if (i < nt && s < p.S)
      km.pos = PAGED ? kp[page * p.kpos_sp + s % p.page_size] : kp[s];
    return km;
  };
  auto store_meta = [&](int i, int32_t page, const KeyMeta& km) {
    kpos_s[i % META][tid] = km.pos;
    if (tid == 0) ktile_s[i % META] = tile_of(i);
    if constexpr (PAGED) {
      kpage_s[i % META][tid] = page;
      krow_s[i % META][tid] = (tile_of(i) * KT + tid) % p.page_size;
    }
  };
  // bulk-copy tile i's K rows (IS_V: its V rows) into buffer `buf` on its
  // barrier: key row j by warp j (KT == WARPS), so no warp waits long on
  // the copy engine; rows past S are zeroed (a masked key must add
  // exactly 0, so its V row must be finite)
  static_assert(KT == F::WARPS, "a key row a warp");
  auto issue_rows = [&](int i, int buf, auto is_v_c) {
    constexpr bool is_v = decltype(is_v_c)::value;
    constexpr int D = is_v ? DV : DK, pitch = is_v ? VP : KP;
    constexpr uint32_t row_bytes = D * sizeof(KVT);
    KVT* dst = buf_s + buf * KT * KP + warp * pitch;
    const int s0 = ktile_s[i % META] * KT, s = s0 + warp;
    if (s < p.S) {
      if (lane == 0) {
        int64_t off;
        if constexpr (PAGED)
          off = static_cast<int64_t>(kpage_s[i % META][warp]) *
                    (is_v ? p.v_sp : p.k_sp) +
                static_cast<int64_t>(krow_s[i % META][warp]) *
                    (is_v ? p.v_ss : p.k_ss);
        else
          off = static_cast<int64_t>(s) * (is_v ? p.v_ss : p.k_ss);
        if (warp == 0) mbar_expect(&bar_s[buf], min(KT, p.S - s0) * row_bytes);
        bulk_copy(dst, (is_v ? vb : kb) + off, row_bytes, &bar_s[buf]);
      }
    } else {
      for (int e = lane; e < D; e += 32) dst[e] = KVT(0.f);
    }
  };
  uint32_t parity = 0;   // bit b: the phase parity buffer b's barrier is in
  auto wait_buf = [&](int buf) {
    mbar_wait(&bar_s[buf], (parity >> buf) & 1u);
    parity ^= 1u << buf;
  };

  // O: rows prow + 16 mi + g8 (+ 8), columns pcol + 8 n + 2 t4 (+ 1)
  float o[MR][VN][4];
#pragma unroll
  for (int mi = 0; mi < MR; ++mi)
#pragma unroll
    for (int n = 0; n < VN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[mi][n][e] = 0.f;
  float m_run = NEG_INF;   // the softmax threads' row state
  float l_run = 0.f;

  // prologue: the barriers, metadata of tiles 0 and 1, q and K(0)
  if (tid == 0) {
    mbar_init(&bar_s[0]);
    mbar_init(&bar_s[1]);
    mbar_init(&bar_s[2]);
  }
  int32_t page_next = 0;   // paged: block-table entry of tile i + 2
  int live0 = 0, live1 = 0;
  if (tid < KT) {
    int32_t pg0 = 0, pg1 = 0;
    if constexpr (PAGED) {
      pg0 = block_page(0);
      pg1 = block_page(1);
      page_next = block_page(2);
    }
    const KeyMeta a = load_meta(0, pg0), c1 = load_meta(1, pg1);
    store_meta(0, pg0, a);
    store_meta(1, pg1, c1);
    live0 = 0 < nt && live_key(a.pos);
    live1 = 1 < nt && live_key(c1.pos);
  }
  if constexpr (DKS != DK) {   // the zero columns q and K are padded with
    // (buffer 1 holds V rows, of no padding, unless V is read out of K)
    const int rows = ROWS + (alias ? 2 : 1) * KT;
    for (int e = tid; e < rows * (DKS - DK); e += THREADS) {
      const int row = e / (DKS - DK), col = DK + e % (DKS - DK);
      if (row < ROWS)
        q_s[row * QP + col] = QT(0.f);
      else
        buf_s[(row - ROWS) * KP + col] = KVT(0.f);
    }
  }
  int cur_live = __syncthreads_or(live0);
  int next_live = __syncthreads_or(live1);
  if (nt > 0) {   // q: rows 4 w .. 4 w + 3 by lanes 0-3 of warp w
    constexpr uint32_t row_bytes = DK * sizeof(QT);
    constexpr int RPW = ROWS / F::WARPS;
    static_assert(ROWS % F::WARPS == 0 && RPW <= 32, "q rows a warp");
    const int rr = warp * RPW + lane, r = r0 + rr;
    if (tid == 0) mbar_expect(&bar_s[2], min(ROWS, R - r0) * row_bytes);
    if (lane < RPW && r < R)
      bulk_copy(q_s + rr * QP, static_cast<const QT*>(p.q) + b * p.q_sb +
                                   h * p.q_sh + (r / p.G) * p.q_st +
                                   (r % p.G) * p.q_sg,
                row_bytes, &bar_s[2]);
    for (int x = 0; x < RPW; ++x)
      if (r0 + warp * RPW + x >= R)
        for (int e = lane; e < DK; e += 32)
          q_s[(warp * RPW + x) * QP + e] = QT(0.f);
  }
  if (cur_live) issue_rows(0, 0, std::false_type{});
  if (nt > 0) mbar_wait(&bar_s[2], 0);
  __syncthreads();   // zeroed rows (past R or S) are seen by every warp

  // Q·Kᵀ: this warp's k-steps are KQ kq .. KQ kq + KQ - 1 (a quarter)
  constexpr int KQ = F::KQ;
  float* spw = sp_s + (kq & 1) * ROWS * KT + (16 * rg + g8) * KT + 2 * t4;
  for (int i = 0; i < nt; ++i) {
    // aliased: K(i + 1) into the other buffer; else V(i) into buffer 1
    // (the barrier ending tile i - 1 freed both)
    if (alias && next_live)
      issue_rows(i + 1, (i + 1) & 1, std::false_type{});
    else if (!alias && cur_live)
      issue_rows(i, 1, std::true_type{});
    // metadata of tile i + 2 (and the page of tile i + 3) in flight
    KeyMeta ahead{-1, 0, 0};
    const int32_t page_ahead = page_next;
    if (tid < KT) {
      ahead = load_meta(i + 2, page_next);
      if constexpr (PAGED) page_next = block_page(i + 3);
    }
    // a tile with no live key: nothing to wait for or compute
    if (!cur_live) {
      if (!alias && next_live) issue_rows(i + 1, 0, std::false_type{});
    } else {
      const int kbuf = alias ? (i & 1) : 0;
      wait_buf(kbuf);                                     // K(i)
      const KVT* ks = buf_s + kbuf * KT * KP;
      // ---- S = Q·Kᵀ over this warp's k-quarter: rows 16 rg + g8 (+ 8),
      // keys 8 j + 2 t4 (+ 1); three sums (hi·hi, lo·hi, hi·lo). Quarters 2
      // and 3 store theirs to the two partial tiles, then quarters 0 and 1
      // add theirs: S = (q0 + q2) + (q1 + q3), in a fixed order.
      float s4[2][4];
      if constexpr (KEX) {
        // bf16 K: m16n8k16 bf16, q in two bf16 halves (one, bf16 q)
        constexpr int KS = DKS / 16, KQ16 = (KS + 3) / 4;
        float d[2][2][4];
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int x = 0; x < 2; ++x)
#pragma unroll
            for (int e = 0; e < 4; ++e) d[j][x][e] = 0.f;
        const QT* qa = q_s + (16 * rg + g8) * QP + 16 * KQ16 * kq + 2 * t4;
        const KVT* kr = ks + g8 * KP + 16 * KQ16 * kq + 2 * t4;
#pragma unroll
        for (int m = 0; m < KQ16; ++m) {
          if (KS % 4 != 0 && KQ16 * kq + m >= KS) continue;
          uint32_t ah[4], al[4];
          bf16_pair(qa + 16 * m, ah[0], al[0]);
          bf16_pair(qa + 8 * QP + 16 * m, ah[1], al[1]);
          bf16_pair(qa + 16 * m + 8, ah[2], al[2]);
          bf16_pair(qa + 8 * QP + 16 * m + 8, ah[3], al[3]);
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const KVT* kj = kr + 8 * j * KP + 16 * m;
            const uint32_t bb[2] = {
                *reinterpret_cast<const uint32_t*>(kj),
                *reinterpret_cast<const uint32_t*>(kj + 8)};
            if (!QEX) mma_bf16(d[j][1], al, bb);
            mma_bf16(d[j][0], ah, bb);
          }
        }
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s4[j][e] = d[j][0][e] + d[j][1][e];
      } else {
        float d[2][3][4];
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int x = 0; x < 3; ++x)
#pragma unroll
            for (int e = 0; e < 4; ++e) d[j][x][e] = 0.f;
        const QT* qa = q_s + (16 * rg + g8) * QP + 8 * KQ * kq + t4;
        const KVT* kr = ks + g8 * KP + 8 * KQ * kq + t4;
#pragma unroll
        for (int m = 0; m < KQ; ++m) {
          if (KSTEPS % 4 != 0 && KQ * kq + m >= KSTEPS) continue;
          uint32_t ah[4], al[4];
          tf32_split<QEX>(ld_bits(qa + 8 * m), ah[0], al[0]);
          tf32_split<QEX>(ld_bits(qa + 8 * QP + 8 * m), ah[1], al[1]);
          tf32_split<QEX>(ld_bits(qa + 8 * m + 4), ah[2], al[2]);
          tf32_split<QEX>(ld_bits(qa + 8 * QP + 8 * m + 4), ah[3], al[3]);
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            uint32_t bh[2], bl[2];
            tf32_split<false>(ld_bits(kr + 8 * j * KP + 8 * m), bh[0], bl[0]);
            tf32_split<false>(ld_bits(kr + 8 * j * KP + 8 * m + 4), bh[1],
                              bl[1]);
            if (!QEX) mma_tf32(d[j][1], al, bh);
            mma_tf32(d[j][2], ah, bl);
            mma_tf32(d[j][0], ah, bh);
          }
        }
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            s4[j][e] = d[j][0][e] + (d[j][1][e] + d[j][2][e]);
      }
      if (kq >= 2) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          *reinterpret_cast<float2*>(spw + 8 * j) =
              make_float2(s4[j][0], s4[j][1]);
          *reinterpret_cast<float2*>(spw + 8 * KT + 8 * j) =
              make_float2(s4[j][2], s4[j][3]);
        }
      }
      __syncthreads();
      if (kq < 2) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          float2* a = reinterpret_cast<float2*>(spw + 8 * j);
          float2* c = reinterpret_cast<float2*>(spw + 8 * KT + 8 * j);
          const float2 x = *a, y = *c;
          *a = make_float2(s4[j][0] + x.x, s4[j][1] + x.y);
          *c = make_float2(s4[j][2] + y.x, s4[j][3] + y.y);
        }
      }
      __syncthreads();
      // not aliased: K(i + 1) into buffer 0 (Q·Kᵀ(i) is done with it)
      if (!alias && next_live) issue_rows(i + 1, 0, std::false_type{});

      // ---- online softmax over the tile's 16 keys (the GQA form's
      // arithmetic); P into partial tile 0, the row's correction to corr_s
      {
        const int32_t* kpos_t = kpos_s[i % META];
        const int s0 = ktile_s[i % META] * KT;
        float* psr = sp_s + srow * KT + SKEYS * sq;
        float sc[SKEYS];
        bool ok[SKEYS];
        float tmax = NEG_INF;
#pragma unroll
        for (int i2 = 0; i2 < SKEYS; ++i2) {
          const int j = SKEYS * sq + i2;
          const int kpos = kpos_t[j];
          bool valid = srow_ok && kpos >= 0;
          if (p.causal) valid = valid && kpos <= qpos;
          if (p.window > 0) valid = valid && (qpos - kpos < p.window);
          if (mrow != nullptr)
            valid = valid && s0 + j < p.S && mrow[s0 + j] != 0;
          sc[i2] = valid ? (psr[i2] + psr[i2 + ROWS * KT]) * p.scale : NEG_INF;
          ok[i2] = valid;
          tmax = fmaxf(tmax, sc[i2]);
        }
#pragma unroll
        for (int off = SPT / 2; off > 0; off >>= 1)
          tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, off));
        const float m_new = fmaxf(m_run, tmax);
        float psum = 0.f;
#pragma unroll
        for (int i2 = 0; i2 < SKEYS; ++i2) {
          const float pv = ok[i2] ? expf(sc[i2] - m_new) : 0.f;
          psr[i2] = pv;
          psum += pv;
        }
#pragma unroll
        for (int off = SPT / 2; off > 0; off >>= 1)
          psum += __shfl_xor_sync(0xffffffffu, psum, off);
        const float corr = expf(m_run - m_new);
        l_run = l_run * corr + psum;
        m_run = m_new;
        if (sq == 0) corr_s[srow] = corr;
      }
      if (!alias) wait_buf(1);                            // V(i)
      __syncthreads();

      // ---- O = O corr + P·V: k = t4 is key 8 j + 2 t4 and k = t4 + 4 key
      // 8 j + 2 t4 + 1, so a thread's two P values are adjacent; each V
      // fragment serves the warp's MR row tiles
      {
#pragma unroll
        for (int mi = 0; mi < MR; ++mi) {
          const float c0 = corr_s[prow + 16 * mi + g8];
          const float c1 = corr_s[prow + 16 * mi + g8 + 8];
#pragma unroll
          for (int n = 0; n < VN; ++n) {
            o[mi][n][0] *= c0;
            o[mi][n][1] *= c0;
            o[mi][n][2] *= c1;
            o[mi][n][3] *= c1;
          }
        }
        const KVT* vs = alias ? ks : buf_s + KT * KP;
        const int vp = alias ? KP : VP;
        if constexpr (KEX) {
          // bf16 V: m16n8k16 bf16 over the tile's 16 keys, P in two bf16
          // halves, V fragments transposed by `ldmatrix`
          uint32_t ah[MR][4], al[MR][4];
#pragma unroll
          for (int mi = 0; mi < MR; ++mi) {
            const float* pr = sp_s + (prow + 16 * mi + g8) * KT + 2 * t4;
            bf16_pair(pr, ah[mi][0], al[mi][0]);
            bf16_pair(pr + 8 * KT, ah[mi][1], al[mi][1]);
            bf16_pair(pr + 8, ah[mi][2], al[mi][2]);
            bf16_pair(pr + 8 * KT + 8, ah[mi][3], al[mi][3]);
          }
          const KVT* vrow = vs + (lane % 16) * vp + pcol;
#pragma unroll
          for (int n = 0; n < VN; ++n) {
            uint32_t bb[2];
            ldmatrix_b(bb, vrow + 8 * n);
#pragma unroll
            for (int mi = 0; mi < MR; ++mi) {
              mma_bf16(o[mi][n], al[mi], bb);
              mma_bf16(o[mi][n], ah[mi], bb);
            }
          }
        } else {
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            uint32_t ah[MR][4], al[MR][4];
#pragma unroll
            for (int mi = 0; mi < MR; ++mi) {
              const float* pr =
                  sp_s + (prow + 16 * mi + g8) * KT + 8 * j + 2 * t4;
              const float2 pa = *reinterpret_cast<const float2*>(pr);
              const float2 pb = *reinterpret_cast<const float2*>(pr + 8 * KT);
              tf32_split<false>(__float_as_uint(pa.x), ah[mi][0], al[mi][0]);
              tf32_split<false>(__float_as_uint(pb.x), ah[mi][1], al[mi][1]);
              tf32_split<false>(__float_as_uint(pa.y), ah[mi][2], al[mi][2]);
              tf32_split<false>(__float_as_uint(pb.y), ah[mi][3], al[mi][3]);
            }
            const KVT* v0 = vs + (8 * j + 2 * t4) * vp + pcol + g8;
            const KVT* v1 = v0 + vp;
#pragma unroll
            for (int n = 0; n < VN; ++n) {
              uint32_t bh[2], bl[2];
              tf32_split<false>(ld_bits(v0 + 8 * n), bh[0], bl[0]);
              tf32_split<false>(ld_bits(v1 + 8 * n), bh[1], bl[1]);
#pragma unroll
              for (int mi = 0; mi < MR; ++mi) {
                mma_tf32(o[mi][n], al[mi], bh);
                mma_tf32(o[mi][n], ah[mi], bl);
                mma_tf32(o[mi][n], ah[mi], bh);
              }
            }
          }
        }
      }
    }

    // metadata of tile i + 2 lands; every thread is done with the buffers
    int live2 = 0;
    if (tid < KT) {
      store_meta(i + 2, page_ahead, ahead);
      live2 = i + 2 < nt && live_key(ahead.pos);
    }
    const int l2 = __syncthreads_or(live2);
    cur_live = next_live;
    next_live = l2;
  }

  // this thread's output rows of O and the softmax row's (m, l)
  auto out_row = [&](int r) -> int64_t {
    return ((static_cast<int64_t>(b) * p.T + r / p.G) * p.H + h) * p.G +
           r % p.G;
  };
  const int ocol = pcol + 2 * t4;
  if (p.n_split == 1) {
#pragma unroll
    for (int mi = 0; mi < MR; ++mi) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int r = r0 + prow + 16 * mi + 8 * hf + g8;
        if (r < R) {
          float* dst = p.acc + out_row(r) * DV + ocol;
#pragma unroll
          for (int n = 0; n < VN; ++n)
            *reinterpret_cast<float2*>(dst + 8 * n) =
                make_float2(o[mi][n][2 * hf], o[mi][n][2 * hf + 1]);
        }
      }
    }
    if (sq == 0 && srow_ok) {
      p.m[out_row(sr)] = m_run;
      p.l[out_row(sr)] = l_run;
    }
    return;
  }

  // merge the cluster's n_split partials in rank order (merge_partials'
  // arithmetic); the staging memory is free now and holds this block's O
  // and, per row, the factors (ea, eb) of each step of the fold
  __syncthreads();
  float* mrg_acc = reinterpret_cast<float*>(lsm);   // [ROWS][DV]
  float* fac = mrg_acc + ROWS * DV;                 // [ROWS][MAX_SPLIT][2]
#pragma unroll
  for (int mi = 0; mi < MR; ++mi) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float* dst = mrg_acc + (prow + 16 * mi + 8 * hf + g8) * DV + ocol;
#pragma unroll
      for (int n = 0; n < VN; ++n)
        *reinterpret_cast<float2*>(dst + 8 * n) =
            make_float2(o[mi][n][2 * hf], o[mi][n][2 * hf + 1]);
    }
  }
  if (sq == 0) {
    mrg_m[srow] = m_run;
    mrg_l[srow] = l_run;
  }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  // each row's fold over the ranks, once: m and l, and the factors that
  // every column of the row applies
  if (tid < ROWS && r0 + tid < R) {
    float mq[MAX_SPLIT], lq[MAX_SPLIT];   // every remote load in flight
#pragma unroll
    for (int q = 0; q < MAX_SPLIT; ++q) {
      mq[q] = q < p.n_split ? cluster.map_shared_rank(mrg_m, q)[tid] : 0.f;
      lq[q] = q < p.n_split ? cluster.map_shared_rank(mrg_l, q)[tid] : 0.f;
    }
    float m_a = mq[0], l_a = lq[0];
#pragma unroll
    for (int q = 1; q < MAX_SPLIT; ++q) {
      if (q < p.n_split) {
        const float mm = fmaxf(m_a, mq[q]);
        const float ea = expf(m_a - mm), eb = expf(mq[q] - mm);
        l_a = l_a * ea + lq[q] * eb;
        m_a = mm;
        fac[(tid * MAX_SPLIT + q) * 2] = ea;
        fac[(tid * MAX_SPLIT + q) * 2 + 1] = eb;
      }
    }
    if (rank == 0) {
      p.m[out_row(r0 + tid)] = m_a;
      p.l[out_row(r0 + tid)] = l_a;
    }
  }
  __syncthreads();
  // this rank's share of the rows' columns, four at a time
  for (int e = rank * THREADS + tid; e < ROWS * DV / 4;
       e += p.n_split * THREADS) {
    const int rr = e / (DV / 4), d = 4 * (e % (DV / 4));
    if (r0 + rr >= R) continue;
    float4 aq[MAX_SPLIT];
#pragma unroll
    for (int q = 0; q < MAX_SPLIT; ++q)
      aq[q] = q < p.n_split
                  ? *reinterpret_cast<const float4*>(
                        cluster.map_shared_rank(mrg_acc, q) + rr * DV + d)
                  : make_float4(0.f, 0.f, 0.f, 0.f);
    float4 a_a = aq[0];
#pragma unroll
    for (int q = 1; q < MAX_SPLIT; ++q) {
      if (q < p.n_split) {
        const float ea = fac[(rr * MAX_SPLIT + q) * 2];
        const float eb = fac[(rr * MAX_SPLIT + q) * 2 + 1];
        a_a.x = a_a.x * ea + aq[q].x * eb;
        a_a.y = a_a.y * ea + aq[q].y * eb;
        a_a.z = a_a.z * ea + aq[q].z * eb;
        a_a.w = a_a.w * ea + aq[q].w * eb;
      }
    }
    *reinterpret_cast<float4*>(p.acc + out_row(r0 + rr) * DV + d) = a_a;
  }
  cluster.sync();   // no block leaves while another reads its partials
}

template <int DK, int DV, typename QT, typename KVT, bool PAGED>
int launch_latent(const Params& p, int B, cudaStream_t stream) {
  using F = LatentForm<DK, DV>;
  if (p.n_split > F::MAX_SPLIT)
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = latent_kernel<DK, DV, QT, KVT, PAGED>;
  constexpr int smem = LatentSmem<DK, DV, QT, KVT>::BYTES;
  static bool attr = false;   // one flag per instantiation
  if (!attr) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         smem);
    attr = true;
  }
  const int R = p.T * p.G;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(((R + F::ROWS - 1) / F::ROWS) * p.n_split, p.H, B);
  cfg.blockDim = dim3(F::THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attrs[1];
  attrs[0].id = cudaLaunchAttributeClusterDimension;
  attrs[0].val.clusterDim.x = p.n_split;
  attrs[0].val.clusterDim.y = 1;
  attrs[0].val.clusterDim.z = 1;
  cfg.attrs = attrs;
  cfg.numAttrs = p.n_split > 1 ? 1 : 0;
  return static_cast<int>(cudaLaunchKernelEx(&cfg, kernel, p));
}

// =====================================================================
// The int8 K/V form (Dk == Dv, `kv_dtype="int8"` caches)
// =====================================================================
//
// With the GQA form it replaces the Pallas TPU kernels
// `flash_attention_partial` (src/repro/kernels/common.py) and
// `paged_flash_decode` (src/repro/kernels/decode_attention/kernel.py)
// for int8 caches. The function is the GQA form's over the reference's
// dequantized view of an int8 cache: K and V are bf16(f32(x8) * scale), one f32 scale per
// (row, KV head) (`dequantize_cache`), and the kernel returns the same
// partials (acc, m, l) under the same masks, split and merge.
//
// What bounds it on the H100. At decode, verification's cache pass and
// commit it reads each held key's 2 x D int8 bytes and two scales once
// for a handful of query rows: bound by those bytes over 3.35 TB/s, 0.1
// to 2.3 us at phase K's shapes, so latency decides. At the T = 512
// prefill the products are 2 x 512 x 2D operations a key; on bf16 tensor
// cores they stay below the bytes, on f32 CUDA cores they would not. In
// practice a tile costs what its warp spends converting int8 to bf16:
// every value needs its own f32 product and rounding (the reference's
// bits), about 3.5 instructions, and a warp of this kernel issues them
// at a fraction of the SM's rate (one 8-warp block fills an SM's
// registers, so each scheduler holds two warps). A first design (an
// instantiation of the GQA kernel) staged a tile one ahead, dequantized
// it in a block-wide pass between two barriers, computed on CUDA cores
// at 16 query rows a block whatever R was, and ran at ~38x its bound.
//
// What this design does about it:
//   * Tiles in flight. Each warp publishes a tile's metadata (positions
//     and the K and V scales of its 32 keys, one lane a key; paged: the
//     page through the block table) in shared memory and issues its
//     16-byte `cp.async` copies into a ring of STAGES int8 tiles; the
//     copies land on the stage's mbarrier (`cp.async.mbarrier.arrive`),
//     and the first STAGES tiles of a block are all in flight before the
//     first is computed. (One `cp.async.bulk` a key row was tried first:
//     at 64-128 bytes a row it was about 7 % slower.) A tile with no live key
//     for the block's rows is neither copied nor computed.
//   * One conversion a value for all the rows that read it. A team of
//     warps that share a tile converts it, 16 bytes a thread at a time,
//     into a bf16 view in shared memory with `dequant_tile`'s arithmetic
//     (the exponent trick, an f32 product, round to nearest even), so
//     every value is the reference's bf16 bit for bit; the team's warps
//     then read their tensor-core fragments from the view by `ldmatrix`
//     (V transposed on the way). Converting straight into each warp's
//     fragments was tried first: it has no view and no barrier, but at
//     64 rows a block each of the 4 warps of a row tile converted the
//     whole tile, and prefill took half as long again.
//   * Both products on tensor cores: `mma.sync` m16n8k16 bf16 with f32
//     accumulation. K and V are exact in bf16 by construction; f32 q and
//     P are split into two bf16 halves (hi, lo: about 2^-17), so each
//     product is two (bf16 q: one). Why not `wgmma`: it needs 4 warps on
//     64 rows of one tile, while decode has 1-10 rows, and the f32 q and
//     P halves double its operands in shared memory.
//   * Rows per block from the grid. A block is 8 warps; its row tile
//     (`RT`, from `ops.py::tiling`: 16 rows where R <= 16, else 64)
//     makes teams of RT / 16 warps, one 16-row group each, and the teams
//     take every (8 / team)-th tile of the block's keys. At 16 rows each
//     warp is its own team; at 64 rows a prefill tile is staged and
//     converted once for 64 rows (72 tiles a head at the target's T =
//     512, not 272). The block's warps fold their partials into the
//     first warp of each row group through shared memory, in a fixed
//     order, in registers.
//   * The grid runs the heaviest blocks first: row tiles are the slowest
//     grid dimension, last rows (the most keys under the causal mask)
//     first, so a prefill's second wave is its lightest blocks.
//   * Head width 120 (h2o-danube3-4b). A 120-byte int8 row is 8-byte
//     aligned only (head h starts 120 h bytes into a key row), so it is
//     staged by 8-byte `cp.async.ca` copies, 15 a row (the warp walks the
//     tile's 480 copies, each lane's row offsets shuffled from the lane
//     that fetched them), and converted 8 bytes at a time. The bf16 view
//     is 128 values wide: its columns 120-127 are zeros written once
//     (never converted into) and q's last 16-deep k-step carries zeros in
//     its upper half, so q·k is exact over 120; P·V's fifteenth 8-wide
//     column tile is loaded alone (`ldmatrix` x2) and no column past 120
//     is computed or stored. Padding was chosen over a last m16n8k8 step:
//     q's zero half is a compile-time zero, so it holds no register, and
//     the k loop keeps one fragment shape (the m16n8k8 variant was not
//     built). No padded copy of the cache is made: the layout stays the
//     reference's (P, S, H, 120) int8 with (P, S, H) f32 scales.
//   * Everything else is the GQA form's: the split plan from the grid
//     alone (with its own target, `ops.py::INT8_SPLIT_TARGET_BLOCKS`),
//     the cluster's ranks merged in a fixed order through distributed
//     shared memory (each row's fold factors computed once), NEG_INF
//     masking, a fully masked row leaving l = 0, and the paged and
//     resident instantiations sharing this body with key addressing the
//     only difference.

// The int8 form's tiling (`ops.py::tiling` and `kernel_smem` mirror it).
template <int D>
struct Int8Form {
  static constexpr int KT = 32;                   // keys per tile
  static constexpr int WARPS = 8;
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int STAGES = 8;                // int8 tiles in flight
  static constexpr int MAX_SPLIT = 16;            // blocks a cluster
  static constexpr int MAX_ROWS = 64;             // row tile 16 or 64
  static constexpr int STAGE = 2 * KT * D;        // an int8 K and V tile
  // the bf16 view's width: D in whole 16-deep k-steps (D 120: 128, its
  // columns 120-127 zeros written once)
  static constexpr int DP = (D + 15) / 16 * 16;
  // a team's bf16 view of one K and V tile: rows padded by 16 bytes, so
  // that the 8 rows an `ldmatrix` reads lie in distinct banks
  static constexpr int VROW = 2 * DP + 16;
  static constexpr int VIEW = 2 * KT * VROW;
  static constexpr int KSTEPS = DP / 16;          // 16-deep steps of q·k
  static constexpr int NT = D / 8;                // 8-wide n-tiles of O
  // the ring of int8 tiles and one view per team (at most WARPS teams);
  // after the key loop the same bytes hold the warps' (o, m, l) handed to
  // the folding warps, then the block's (MAX_ROWS, D) f32 partial with m
  // and l and each row's fold factors (two f32 a rank)
  static constexpr int STAGED = STAGES * STAGE + WARPS * VIEW;
  static constexpr int XCH = (WARPS - 1) * (D / 2 + 4) * 32 * 4;
  static constexpr int MERGE =
      (MAX_ROWS * D + 2 * MAX_ROWS + MAX_ROWS * MAX_SPLIT * 2) * 4;
  static constexpr int BYTES = STAGED > MERGE && STAGED > XCH ? STAGED
                               : MERGE > XCH ? MERGE : XCH;
  static_assert(D % 8 == 0 && D >= 16 && D <= 128, "int8 head width");
  static_assert(STAGES % WARPS == 0, "the first tiles' producers");
};

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               ::"r"(smem_u32(bar)), "r"(count));
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar,
                                            uint32_t count = 1) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(smem_u32(bar)), "r"(count) : "memory");
}
// an arrival on `bar` once every `cp.async` this thread issued so far has
// landed (counted in the barrier's expected arrivals)
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n"
               ::"r"(smem_u32(bar)) : "memory");
}

// Byte b of w (each byte of w an int8 value biased by 0x80) times sc in
// f32: the exponent trick (the byte in the mantissa of 2^23, minus 2^23 +
// 128) gives the int8 value exactly with no conversion unit; the product
// rounds once, as f32(x8) * scale does in the reference.
__device__ __forceinline__ float dequant_byte(uint32_t w, int b, float sc) {
  return (__uint_as_float(__byte_perm(w, 0x4B000000u, 0x7650 + b)) -
          8388736.f) * sc;
}
// bf16(x), bf16(y) as one register (x in the low half), rounded to
// nearest even: the reference's dequantized values
__device__ __forceinline__ uint32_t bf16x2(float x, float y) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<const uint32_t*>(&v);
}
// the 4 (x4) 8x8 b16 matrices whose rows lanes 8 i .. 8 i + 7 point at,
// one register each (`trans`: transposed on the way)
template <bool TRANS>
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const void* row) {
  if constexpr (TRANS)
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
        "[%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(smem_u32(row)));
  else
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(smem_u32(row)));
}

template <int D, typename QT, bool PAGED>
__global__ void __launch_bounds__(Int8Form<D>::THREADS)
int8_kernel(const Params p, const int RT) {
  using F = Int8Form<D>;
  constexpr int KT = F::KT, NST = F::STAGES, WARPS = F::WARPS;
  constexpr int THREADS = F::THREADS, MAX_SPLIT = F::MAX_SPLIT;
  constexpr int KSTEPS = F::KSTEPS, NT = F::NT, VROW = F::VROW;
  constexpr int MAX_ROWS = F::MAX_ROWS;
  constexpr bool QEX = std::is_same<QT, __nv_bfloat16>::value;

  extern __shared__ __align__(16) uint8_t i8sm[];
  __shared__ int32_t pos_s[NST][KT];              // each stage's metadata
  __shared__ float ksc_s[NST][KT], vsc_s[NST][KT];
  __shared__ int32_t live_s[NST];
  __shared__ __align__(8) uint64_t full_s[NST], empty_s[NST];

  const int R = p.T * p.G;
  const int RG = RT / 16;                         // warps of a team (rows)
  const int KS = WARPS / RG;                      // teams (key splits)
  // grid (n_split, H, B x row tiles), the row tiles last and in reverse:
  // the blocks of the last rows, which see the most keys, start first
  const int n_rt = (R + RT - 1) / RT;
  const int B = gridDim.z / n_rt;
  const int rank = blockIdx.x;
  const int r0 = (n_rt - 1 - blockIdx.z / B) * RT;
  const int h = blockIdx.y;
  const int b = blockIdx.z % B;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;        // fragment coordinates
  const int rg = warp % RG, ks = warp / RG;       // this warp's rows, team
  const int slot = PAGED ? 0 : (p.slot_idx ? p.slot_idx[b] : b);
  const int32_t* btab = PAGED ? p.block_table + b * p.bt_sb : nullptr;
  const int32_t* kp = p.k_pos + (PAGED ? 0 : slot * p.kpos_sp);
  const int8_t* kb = static_cast<const int8_t*>(p.k) + h * p.k_sh +
                     (PAGED ? 0 : slot * p.k_sp);
  const int8_t* vb = static_cast<const int8_t*>(p.v) + h * p.v_sh +
                     (PAGED ? 0 : slot * p.v_sp);

  // this block's tiles: spans rank, rank + n_split, ... of span_tiles
  // tiles (as partial_kernel)
  const int n_tiles = (p.S + KT - 1) / KT;
  const int span = p.span_tiles;
  int nt = 0;
  for (int j = rank; j * span < n_tiles; j += p.n_split)
    nt += min(span, n_tiles - j * span);
  auto tile_of = [&](int i) {
    return (rank + p.n_split * (i / span)) * span + i % span;
  };

  // this warp's rows: wr + gq and wr + gq + 8 (x = 0, 1)
  const int wr = r0 + 16 * rg;
  const bool has_rows = wr < R;
  bool row_ok[2];
  int qpos[2];
  const uint8_t* mrow[2];
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    const int r = wr + gq + 8 * x;
    row_ok[x] = r < R;
    const int t = row_ok[x] ? r / p.G : 0;
    qpos[x] = row_ok[x] ? p.q_pos[b * p.qpos_sb + t] : 0;
    mrow[x] = (p.mask != nullptr && row_ok[x])
                  ? p.mask + b * p.mask_sb + t * p.mask_st
                  : nullptr;
  }
  // this thread's values of q for its A fragments, loaded first (in
  // flight with the positions and the first tiles' metadata): at k-step
  // m, d = 16 m + 2 tq (+ 1) and 16 m + 8 + 2 tq (+ 1), in both its rows
  QT qv[2][KSTEPS][4];
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    const int r = wr + gq + 8 * x;
    const QT* qrow = static_cast<const QT*>(p.q) + b * p.q_sb + h * p.q_sh +
                     (row_ok[x] ? (r / p.G) * p.q_st + (r % p.G) * p.q_sg
                                : 0) + 2 * tq;
#pragma unroll
    for (int m = 0; m < KSTEPS; ++m)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        qv[x][m][e] = row_ok[x] && (D % 16 == 0 || 16 * m + 8 * (e >> 1) < D)
                          ? qrow[16 * m + 8 * (e >> 1) + (e & 1)]
                          : QT(0.f);   // (D 120: the k-step's zero half)
  }

  // the block's query-position range (every warp: no barrier needed)
  int qmin = 2147483647, qmax = -2147483647 - 1;
#pragma unroll
  for (int rr = lane; rr < MAX_ROWS; rr += 32) {
    if (rr < RT && r0 + rr < R) {
      const int qp = p.q_pos[b * p.qpos_sb + (r0 + rr) / p.G];
      qmin = min(qmin, qp);
      qmax = max(qmax, qp);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    qmin = min(qmin, __shfl_xor_sync(0xffffffffu, qmin, off));
    qmax = max(qmax, __shfl_xor_sync(0xffffffffu, qmax, off));
  }
  auto live_key = [&](int32_t kpos) {
    return kpos >= 0 && (!p.causal || kpos <= qmax) &&
           (p.window <= 0 || qmin - kpos < p.window);
  };

  // ---- the producer side: tile i into stage i % NST (the first NST
  // tiles by warp i % WARPS, later ones by a consumer of tile i - NST),
  // one lane a key: its metadata (`fetch`: one round trip, paged two),
  // then (`publish`) the stage's metadata in shared memory, its liveness
  // and the 16-byte copies of its K and V rows, which land on the
  // stage's barrier (a stage is refilled once its consumers released it)
  struct Fetched {
    int32_t pos;
    float ksc, vsc;
    int64_t ko, vo;
  };
  auto fetch = [&](int i) -> Fetched {
    const int key = tile_of(i) * KT + lane;
    Fetched f{-1, 0.f, 0.f, 0, 0};
    if (key < p.S) {
      int64_t prow = slot, rw = key;
      if constexpr (PAGED) {
        prow = btab[key / p.page_size];
        rw = key % p.page_size;
      }
      f.pos = kp[PAGED ? prow * p.kpos_sp + rw : rw];
      f.ksc = p.k_scale[prow * p.ksc_sp + rw * p.ksc_ss + h * p.ksc_sh];
      f.vsc = p.v_scale[prow * p.vsc_sp + rw * p.vsc_ss + h * p.vsc_sh];
      f.ko = PAGED ? prow * p.k_sp + rw * p.k_ss : rw * p.k_ss;
      f.vo = PAGED ? prow * p.v_sp + rw * p.v_ss : rw * p.v_ss;
    }
    return f;
  };
  auto publish = [&](int i, const Fetched& f) {
    const int st = i % NST, s0 = tile_of(i) * KT;
    const bool live = __any_sync(0xffffffffu, live_key(f.pos));
    pos_s[st][lane] = f.pos;
    ksc_s[st][lane] = f.ksc;
    vsc_s[st][lane] = f.vsc;
    if (lane == 0) live_s[st] = live;
    if (!live) {   // no copies: all KT + 1 arrivals at once
      __syncwarp();
      if (lane == 0) mbar_arrive(&full_s[st], KT + 1);
      return;
    }
    uint8_t* dst = i8sm + st * F::STAGE;
    if constexpr (D % 16 == 0) {
      // 16-byte copies: each instruction of the warp covers 32 / CPR whole
      // rows (CPR copies a row), row j's offsets from lane j
      constexpr int CPR = D / 16, RPI = 32 / CPR;
      const int part = 16 * (lane % CPR);
#pragma unroll
      for (int it = 0; it < CPR; ++it) {
        const int j = it * RPI + lane / CPR;
        const int64_t kj = __shfl_sync(0xffffffffu, f.ko, j);
        const int64_t vj = __shfl_sync(0xffffffffu, f.vo, j);
        if (s0 + j < p.S) {
          cp_async16(dst + j * D + part, kb + kj + part, 16);
          cp_async16(dst + (KT + j) * D + part, vb + vj + part, 16);
        }
      }
    } else {
      // D 120: a row is 8-byte aligned only, so 8-byte copies, CPR a row;
      // the warp walks the tile's KT CPR copies (a whole number of
      // instructions), copy c of row c / CPR, offsets from that lane
      constexpr int CPR = D / 8;
      static_assert(KT * CPR % 32 == 0, "whole instructions");
#pragma unroll
      for (int it = 0; it < KT * CPR / 32; ++it) {
        const int c = it * 32 + lane, j = c / CPR, part = 8 * (c % CPR);
        const int64_t kj = __shfl_sync(0xffffffffu, f.ko, j);
        const int64_t vj = __shfl_sync(0xffffffffu, f.vo, j);
        if (s0 + j < p.S) {
          cp_async8(dst + j * D + part, kb + kj + part);
          cp_async8(dst + (KT + j) * D + part, vb + vj + part);
        }
      }
    }
    cp_async_arrive(&full_s[st]);   // KT arrivals as the copies land
    __syncwarp();
    if (lane == 0) mbar_arrive(&full_s[st]);   // and the metadata's
  };

  if (tid == 0) {
    for (int st = 0; st < NST; ++st) {
      mbar_init(&full_s[st], KT + 1);
      mbar_init(&empty_s[st], RG);
    }
  }
  if constexpr (F::DP != D) {
    // the views' columns D .. DP - 1 (16 bytes a K or V row): zeros,
    // written once and never converted into, so q's zero half meets 0
    static_assert(2 * (F::DP - D) == 16, "one 16-byte store a row");
    for (int r = tid; r < WARPS * 2 * KT; r += THREADS)
      *reinterpret_cast<uint4*>(i8sm + NST * F::STAGE + r * VROW + 2 * D) =
          make_uint4(0u, 0u, 0u, 0u);
  }
  __syncthreads();
  {  // this warp's first NST / WARPS tiles: every fetch in flight at once
    constexpr int PRO = NST / WARPS;
    Fetched f[PRO];
#pragma unroll
    for (int c = 0; c < PRO; ++c)
      if (warp + WARPS * c < nt) f[c] = fetch(warp + WARPS * c);
#pragma unroll
    for (int c = 0; c < PRO; ++c)
      if (warp + WARPS * c < nt) publish(warp + WARPS * c, f[c]);
  }

  // q as A fragments in bf16 halves (hi, lo): rows gq (a0, a2), gq + 8
  uint32_t qh[KSTEPS][4], ql[KSTEPS][4];
#pragma unroll
  for (int x = 0; x < 2; ++x)
#pragma unroll
    for (int m = 0; m < KSTEPS; ++m) {
      bf16_pair(to_f32(qv[x][m][0]), to_f32(qv[x][m][1]), qh[m][x],
                ql[m][x]);
      bf16_pair(to_f32(qv[x][m][2]), to_f32(qv[x][m][3]), qh[m][2 + x],
                ql[m][2 + x]);
    }

  // O: rows gq (+ 8), columns 8 n + 2 tq (+ 1)
  float o[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m_run[2] = {NEG_INF, NEG_INF};
  float l_run[2] = {0.f, 0.f};

  // the team (the RG warps that share this warp's tiles) and its view
  uint8_t* view = i8sm + NST * F::STAGE + ks * F::VIEW;
  const int tt = rg * 32 + lane, team = 32 * RG;
  auto team_sync = [&]() {
    asm volatile("bar.sync %0, %1;\n" ::"r"(1 + ks), "r"(team) : "memory");
  };

  for (int i = ks; i < nt; i += KS) {
    const int st = i % NST;
    // one of tile i's consumers (the row group (i / KS) % RG) refills
    // stage st with tile i + NST once it is drained: that tile's metadata
    // is fetched while tile i is converted
    const bool refill = rg == (i / KS) % RG && i + NST < nt;
    Fetched nf{-1, 0.f, 0.f, 0, 0};
    if (refill) nf = fetch(i + NST);
    mbar_wait(&full_s[st], (i / NST) & 1);
    const bool live = live_s[st];
    const int s0 = tile_of(i) * KT;
    // the positions of this thread's score columns, kept past the stage's
    // release: keys 8 j + 2 tq (+ 1)
    int kpos_r[4][2];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) kpos_r[j][c] = pos_s[st][8 * j + 2 * tq + c];
    if (live) {
      // ---- the team converts the int8 tile into its bf16 view, 16
      // bytes a step: bf16(f32(x8) * scale), `dequantize_cache` bit for
      // bit (once the team's warps are done with the previous view)
      team_sync();
      const uint8_t* src = i8sm + st * F::STAGE;
      if constexpr (D % 16 == 0) {
        for (int c = tt; c < 4 * D; c += team) {   // 2D chunks of K, of V
          const int row = c / (D / 16);            // 0..31 K, 32..63 V
          const int col = c % (D / 16);
          const float sc = row < KT ? ksc_s[st][row] : vsc_s[st][row - KT];
          const uint4 w = *reinterpret_cast<const uint4*>(src + row * D +
                                                          16 * col);
          const uint32_t ww[4] = {w.x ^ 0x80808080u, w.y ^ 0x80808080u,
                                  w.z ^ 0x80808080u, w.w ^ 0x80808080u};
          uint32_t hv[8];
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            hv[2 * k] = bf16x2(dequant_byte(ww[k], 0, sc),
                               dequant_byte(ww[k], 1, sc));
            hv[2 * k + 1] = bf16x2(dequant_byte(ww[k], 2, sc),
                                   dequant_byte(ww[k], 3, sc));
          }
          uint4* dst = reinterpret_cast<uint4*>(view + row * VROW + 32 * col);
          dst[0] = make_uint4(hv[0], hv[1], hv[2], hv[3]);
          dst[1] = make_uint4(hv[4], hv[5], hv[6], hv[7]);
        }
      } else {   // D 120: 8-byte chunks of the 8-byte aligned rows
        for (int c = tt; c < 2 * KT * (D / 8); c += team) {
          const int row = c / (D / 8), col = c % (D / 8);
          const float sc = row < KT ? ksc_s[st][row] : vsc_s[st][row - KT];
          const uint2 w = *reinterpret_cast<const uint2*>(src + row * D +
                                                          8 * col);
          const uint32_t ww[2] = {w.x ^ 0x80808080u, w.y ^ 0x80808080u};
          uint32_t hv[4];
#pragma unroll
          for (int k = 0; k < 2; ++k) {
            hv[2 * k] = bf16x2(dequant_byte(ww[k], 0, sc),
                               dequant_byte(ww[k], 1, sc));
            hv[2 * k + 1] = bf16x2(dequant_byte(ww[k], 2, sc),
                                   dequant_byte(ww[k], 3, sc));
          }
          *reinterpret_cast<uint4*>(view + row * VROW + 16 * col) =
              make_uint4(hv[0], hv[1], hv[2], hv[3]);
        }
      }
    }
    // the int8 stage is read: release it, and refill it if this warp does
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty_s[st]);
    if (refill) {
      mbar_wait(&empty_s[st], (i / NST) & 1);
      publish(i + NST, nf);
    }
    if (!live) continue;
    team_sync();   // the view is written
    if (!has_rows) continue;
    const uint8_t* kv = view;                     // K rows of the view
    const uint8_t* vv = view + KT * VROW;         // V rows
    // ---- S = q·Kᵀ: n-tile j holds keys 8 j + 2 tq (+ 1), rows gq (+ 8);
    // K's B fragments by `ldmatrix` (two n-tiles a load); the hi and lo
    // products in separate sums
    float sh[4][4], sl[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sh[j][e] = sl[j][e] = 0.f;
    const uint8_t* krow = kv + ((lane & 7) + ((lane >> 4) << 3)) * VROW +
                          ((lane >> 3) & 1) * 16;
#pragma unroll
    for (int m = 0; m < KSTEPS; ++m) {
#pragma unroll
      for (int jp = 0; jp < 2; ++jp) {
        uint32_t bq[4];
        ldmatrix_x4<false>(bq, krow + 16 * jp * VROW + 32 * m);
        const uint32_t b0[2] = {bq[0], bq[1]}, b1[2] = {bq[2], bq[3]};
        mma_bf16(sh[2 * jp], qh[m], b0);
        mma_bf16(sh[2 * jp + 1], qh[m], b1);
        if (!QEX) {
          mma_bf16(sl[2 * jp], ql[m], b0);
          mma_bf16(sl[2 * jp + 1], ql[m], b1);
        }
      }
    }
    // ---- online softmax over the tile's 32 keys: the GQA form's
    // arithmetic, a row's state in its 4 lanes
    float pv[4][4];
    bool ok[4][4];
    float tmax[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int x = e >> 1;
        const int kj = 8 * j + 2 * tq + (e & 1);
        const int kpos = kpos_r[j][e & 1];
        bool valid = row_ok[x] && kpos >= 0;
        if (p.causal) valid = valid && kpos <= qpos[x];
        if (p.window > 0) valid = valid && (qpos[x] - kpos < p.window);
        if (mrow[x] != nullptr)
          valid = valid && s0 + kj < p.S && mrow[x][s0 + kj] != 0;
        const float sc = valid ? (sh[j][e] + sl[j][e]) * p.scale : NEG_INF;
        pv[j][e] = sc;
        ok[j][e] = valid;
        tmax[x] = fmaxf(tmax[x], sc);
      }
    }
    float corr[2];
#pragma unroll
    for (int x = 0; x < 2; ++x) {
#pragma unroll
      for (int off = 1; off < 4; off <<= 1)
        tmax[x] = fmaxf(tmax[x], __shfl_xor_sync(0xffffffffu, tmax[x], off));
      const float m_new = fmaxf(m_run[x], tmax[x]);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 2 * x; e < 2 * x + 2; ++e) {
          pv[j][e] = ok[j][e] ? expf(pv[j][e] - m_new) : 0.f;
          psum += pv[j][e];
        }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1)
        psum += __shfl_xor_sync(0xffffffffu, psum, off);
      corr[x] = expf(m_run[x] - m_new);
      l_run[x] = l_run[x] * corr[x] + psum;
      m_run[x] = m_new;
    }
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      o[n][0] *= corr[0];
      o[n][1] *= corr[0];
      o[n][2] *= corr[1];
      o[n][3] *= corr[1];
    }
    // ---- O += P·V over two 16-key steps: P's A fragments are the score
    // fragments of n-tiles 2 kk and 2 kk + 1, split into bf16 halves; V's
    // B fragments by `ldmatrix.trans` (two n-tiles a load)
    const uint8_t* vrow = vv + ((lane & 7) + ((lane >> 3) & 1) * 8) * VROW +
                          (lane >> 4) * 16;
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      uint32_t ah[4], al[4];
      bf16_pair(pv[2 * kk][0], pv[2 * kk][1], ah[0], al[0]);
      bf16_pair(pv[2 * kk][2], pv[2 * kk][3], ah[1], al[1]);
      bf16_pair(pv[2 * kk + 1][0], pv[2 * kk + 1][1], ah[2], al[2]);
      bf16_pair(pv[2 * kk + 1][2], pv[2 * kk + 1][3], ah[3], al[3]);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t bv[4];
        ldmatrix_x4<true>(bv, vrow + 16 * kk * VROW + 32 * np);
        const uint32_t b0[2] = {bv[0], bv[1]}, b1[2] = {bv[2], bv[3]};
        mma_bf16(o[2 * np], al, b0);
        mma_bf16(o[2 * np], ah, b0);
        mma_bf16(o[2 * np + 1], al, b1);
        mma_bf16(o[2 * np + 1], ah, b1);
      }
      if constexpr (NT % 2 != 0) {   // D 120: the 15th n-tile alone
        uint32_t bv[2];
        ldmatrix_b(bv, reinterpret_cast<const __nv_bfloat16*>(
                           vv + (lane % 16 + 16 * kk) * VROW +
                           16 * (NT - 1)));
        mma_bf16(o[NT - 1], al, bv);
        mma_bf16(o[NT - 1], ah, bv);
      }
    }
  }

  // ---- the block's partial: the warps that share rows (KS of them)
  // hand their (o, m, l) to the one with ks = 0 through shared memory in
  // fragment order (the ring is free: every copy was waited for), which
  // folds them in order ks = 1, 2, ... (merge_partials' arithmetic)
  constexpr int NV = NT * 4;                      // o values a thread
  __syncthreads();
  float* xch = reinterpret_cast<float*>(i8sm);    // [WARPS - RG][NV + 4][32]
  if (ks > 0) {
    float* dst = xch + ((ks - 1) * RG + rg) * (NV + 4) * 32 + lane;
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dst[(n * 4 + e) * 32] = o[n][e];
    dst[NV * 32] = m_run[0];
    dst[(NV + 1) * 32] = m_run[1];
    dst[(NV + 2) * 32] = l_run[0];
    dst[(NV + 3) * 32] = l_run[1];
  }
  __syncthreads();
  if (ks == 0) {
    for (int q = 1; q < min(KS, nt); ++q) {   // warps past nt hold nothing
      const float* src = xch + ((q - 1) * RG + rg) * (NV + 4) * 32 + lane;
      float ea[2], eb[2];
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        const float mq = src[(NV + x) * 32], lq = src[(NV + 2 + x) * 32];
        const float mm = fmaxf(m_run[x], mq);
        ea[x] = expf(m_run[x] - mm);
        eb[x] = expf(mq - mm);
        l_run[x] = l_run[x] * ea[x] + lq * eb[x];
        m_run[x] = mm;
      }
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          o[n][e] = o[n][e] * ea[e >> 1] + src[(n * 4 + e) * 32] * eb[e >> 1];
    }
  }
  const bool holds = ks == 0;                     // holds block rows
  auto out_row = [&](int r) -> int64_t {
    return ((static_cast<int64_t>(b) * p.T + r / p.G) * p.H + h) * p.G +
           r % p.G;
  };
  if (p.n_split == 1) {   // straight from registers
    if (holds) {
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        const int r = wr + gq + 8 * x;
        if (!row_ok[x]) continue;
        float* dst = p.acc + out_row(r) * D + 2 * tq;
#pragma unroll
        for (int n = 0; n < NT; ++n)
          *reinterpret_cast<float2*>(dst + 8 * n) =
              make_float2(o[n][2 * x], o[n][2 * x + 1]);
        if (tq == 0) {
          p.m[out_row(r)] = m_run[x];
          p.l[out_row(r)] = l_run[x];
        }
      }
    }
    return;
  }
  // the block partial into shared memory, rows of [RT][D], for the
  // cluster's fold
  __syncthreads();
  float* part = reinterpret_cast<float*>(i8sm);   // [RT][D]
  float* part_m = part + MAX_ROWS * D;            // [RT]
  float* part_l = part_m + MAX_ROWS;
  float* fac = part_l + MAX_ROWS;                 // [RT][MAX_SPLIT][2]
  if (holds) {
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      const int pr = 16 * rg + gq + 8 * x;
      float* dst = part + pr * D + 2 * tq;
#pragma unroll
      for (int n = 0; n < NT; ++n)
        *reinterpret_cast<float2*>(dst + 8 * n) =
            make_float2(o[n][2 * x], o[n][2 * x + 1]);
      if (tq == 0) {
        part_m[pr] = m_run[x];
        part_l[pr] = l_run[x];
      }
    }
  }

  // ---- the cluster's n_split block partials in rank order (as the
  // latent form): each row's fold once, then each rank its share of the
  // rows' columns, four at a time
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  if (tid < RT && r0 + tid < R) {
    float mq[MAX_SPLIT], lq[MAX_SPLIT];   // every remote load in flight
#pragma unroll
    for (int q = 0; q < MAX_SPLIT; ++q) {
      mq[q] = q < p.n_split ? cluster.map_shared_rank(part_m, q)[tid] : 0.f;
      lq[q] = q < p.n_split ? cluster.map_shared_rank(part_l, q)[tid] : 0.f;
    }
    float m_a = mq[0], l_a = lq[0];
#pragma unroll
    for (int q = 1; q < MAX_SPLIT; ++q) {
      if (q < p.n_split) {
        const float mm = fmaxf(m_a, mq[q]);
        const float ea = expf(m_a - mm), eb = expf(mq[q] - mm);
        l_a = l_a * ea + lq[q] * eb;
        m_a = mm;
        fac[(tid * MAX_SPLIT + q) * 2] = ea;
        fac[(tid * MAX_SPLIT + q) * 2 + 1] = eb;
      }
    }
    if (rank == 0) {
      p.m[out_row(r0 + tid)] = m_a;
      p.l[out_row(r0 + tid)] = l_a;
    }
  }
  __syncthreads();
  for (int e = rank * THREADS + tid; e < RT * D / 4;
       e += p.n_split * THREADS) {
    const int rr = e / (D / 4), d = 4 * (e % (D / 4));
    if (r0 + rr >= R) continue;
    float4 aq[MAX_SPLIT];
#pragma unroll
    for (int q = 0; q < MAX_SPLIT; ++q)
      aq[q] = q < p.n_split
                  ? *reinterpret_cast<const float4*>(
                        cluster.map_shared_rank(part, q) + rr * D + d)
                  : make_float4(0.f, 0.f, 0.f, 0.f);
    float4 a_a = aq[0];
#pragma unroll
    for (int q = 1; q < MAX_SPLIT; ++q) {
      if (q < p.n_split) {
        const float ea = fac[(rr * MAX_SPLIT + q) * 2];
        const float eb = fac[(rr * MAX_SPLIT + q) * 2 + 1];
        a_a.x = a_a.x * ea + aq[q].x * eb;
        a_a.y = a_a.y * ea + aq[q].y * eb;
        a_a.z = a_a.z * ea + aq[q].z * eb;
        a_a.w = a_a.w * ea + aq[q].w * eb;
      }
    }
    *reinterpret_cast<float4*>(p.acc + out_row(r0 + rr) * D + d) = a_a;
  }
  cluster.sync();   // no block leaves while another reads its partials
}

template <int D, typename QT, bool PAGED>
int launch_int8(const Params& p, int B, int row_tile, cudaStream_t stream) {
  using F = Int8Form<D>;
  if (p.n_split > F::MAX_SPLIT || (row_tile != 16 && row_tile != 64) ||
      p.k_scale == nullptr || p.v_scale == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = int8_kernel<D, QT, PAGED>;
  constexpr int smem = F::BYTES;
  static bool attr = false;   // one flag per instantiation
  if (!attr) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         smem);
    cudaFuncSetAttribute(kernel,
                         cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    attr = true;
  }
  const int R = p.T * p.G;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.n_split, p.H, ((R + row_tile - 1) / row_tile) * B);
  cfg.blockDim = dim3(F::THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attrs[1];
  attrs[0].id = cudaLaunchAttributeClusterDimension;
  attrs[0].val.clusterDim.x = p.n_split;
  attrs[0].val.clusterDim.y = 1;
  attrs[0].val.clusterDim.z = 1;
  cfg.attrs = attrs;
  cfg.numAttrs = p.n_split > 1 ? 1 : 0;
  return static_cast<int>(cudaLaunchKernelEx(&cfg, kernel, p, row_tile));
}

// =====================================================================
// The many-row form (Dk == Dv, f32 or bf16 K/V, R >= `ops.py::R_MMA`)
// =====================================================================
//
// With the GQA form it replaces the Pallas TPU kernels
// `flash_attention_partial` (src/repro/kernels/common.py) and
// `paged_flash_decode` (src/repro/kernels/decode_attention/kernel.py)
// where a (request, KV head) has many query rows: prefill chunks, the
// commit and, at G = 4, verification's cache pass and segment, the
// cross reads of a frontend prefill and the Whisper encoder. The function
// is the GQA form's: partials (m, l, acc) under the same masks, split and
// merge, over the same 32-key tiles.
//
// What bounds it on the H100. A 512-token prefill at G = 4 is R = 2048
// rows a KV head, each scoring every key it sees over D and summing D
// values of V: 2 x 2D operations a (row, key) pair against 2D bytes a key
// (bf16), so the products, not the bytes, bound it. `partial_kernel`
// runs them as f32 FMAs on CUDA cores (67 TFLOP/s) at 16 rows a block,
// staging each key tile once per 16 rows and reading shared memory once
// per FMA: at D 120 bf16 its prefill took 2.6x SDPA's time, the
// encoder's T = S = 1500 read 2.7x.
//
// What this design does about it (FlashAttention-2's layout on
// `mma.sync`, with the latent form's arithmetic):
//   * 64 rows share a tile. A block owns 64 query rows (token-major, r =
//     t G + g), 16 a warp, and stages each 32-key K and V tile once for
//     all of them: 16-byte `cp.async` copies into a double buffer (the
//     GQA form's pipeline: metadata two tiles ahead, tiles with no live
//     key neither copied nor computed), rows padded to 16 bytes past a
//     multiple of 128 so that every fragment load is conflict-free.
//   * Both products on tensor cores, all in registers. A warp's q is held
//     as A fragments for the whole key loop; S = q·Kᵀ for its 16 rows and
//     the tile's 32 keys stays in the accumulator registers, the online
//     softmax runs there (a row's state in its 4 lanes), and P is fed
//     back as P·V's A fragments without leaving them (P's k order is
//     permuted for TF32 so that a thread's two P values are its own: no
//     shuffle); O (16 rows x D) stays in registers. No block barrier but
//     the tile pipeline's.
//   * f32 K/V: m16n8k8 3xTF32 (hi·hi + lo·hi + hi·lo, about 2^-19; bf16
//     q is exact in TF32 and skips its residual product), as the latent
//     form; D 120 is fifteen 8-deep steps and P·V fifteen 8-wide column
//     tiles, every warp taking all of its rows' columns. bf16 K/V:
//     m16n8k16 bf16, K and V exact, f32 q and P split into two bf16 halves
//     (about 2^-17), K's fragments by `ldmatrix`, V's by `ldmatrix.trans`;
//     at D 120 the staged rows are padded with zero columns 120-127,
//     written once (cp.async fills only the first 240 bytes of a row), and
//     q's last k-step has a zero half, so the products are exact; P·V's
//     fifteenth column tile is loaded alone.
//   * The grid runs the heaviest row tiles first (the last rows see the
//     most keys under the causal mask), and the split plan, the cluster
//     merge in rank order and NEG_INF masking are the int8 form's, with
//     the GQA form's block target (`ops.py::plan_splits` at a row tile of
//     64), so a page pool read through its block table gives the resident
//     kernel's bits on the gathered view.
// Why not `wgmma`: 3xTF32 would need split copies of q and K in shared
// memory and V key-major is not K-major for TF32 P·V; and decode-sized R
// stays on `partial_kernel` (`R_MMA`, measured).

// The many-row form's tiling (`ops.py::tiling` and `kernel_smem` mirror
// it).
template <int D, typename KVT>
struct RowsForm {
  static constexpr int ROWS = 64;                 // query rows per block
  static constexpr int WARPS = ROWS / 16;         // 16 rows a warp
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int KT = 32;                   // keys per tile (Form's)
  static constexpr int MAX_SPLIT = 16;            // blocks a cluster
  static constexpr bool BF = std::is_same<KVT, __nv_bfloat16>::value;
  // staged row width: bf16 rows padded with zeros to whole 16-deep
  // k-steps (D 120: 128); f32 rows are read in 8-deep TF32 steps
  static constexpr int DS = BF ? (D + 15) / 16 * 16 : D;
  static constexpr int PITCH = latent_pitch<KVT>(DS);   // elements a row
  static constexpr int TILE = KT * PITCH;               // elements a tile
  static constexpr int STAGED = 4 * TILE * int(sizeof(KVT));  // [2][K, V]
  // after the key loop: the block's (ROWS, D) f32 partial, m, l and each
  // row's fold factors (two f32 a rank)
  static constexpr int MERGE =
      (ROWS * D + 2 * ROWS + ROWS * MAX_SPLIT * 2) * 4;
  static constexpr int BYTES = STAGED > MERGE ? STAGED : MERGE;
  static constexpr int NT = D / 8;                // 8-wide n-tiles of O
  static constexpr int NJ = KT / 8;               // 8-key n-tiles of S
  static constexpr int CPR = D * int(sizeof(KVT)) / 16;  // copies a row
  static_assert(D % 8 == 0 && D * int(sizeof(KVT)) % 16 == 0, "row copies");
  static_assert(KT == 32, "the GQA form's key tile");
};

// the head widths the many-row form is instantiated for
__host__ __device__ constexpr bool rows_form(int d) {
  return d == 64 || d == 120 || d == 128;
}

template <int D, typename QT, typename KVT, bool PAGED>
__global__ void __launch_bounds__(RowsForm<D, KVT>::THREADS)
rows_kernel(const Params p) {
  using F = RowsForm<D, KVT>;
  constexpr int ROWS = F::ROWS, KT = F::KT, THREADS = F::THREADS;
  constexpr int MAX_SPLIT = F::MAX_SPLIT, NT = F::NT, NJ = F::NJ;
  constexpr int PITCH = F::PITCH, TILE = F::TILE, DS = F::DS;
  constexpr int PB = PITCH * int(sizeof(KVT));   // row pitch, bytes
  constexpr bool QEX = std::is_same<QT, __nv_bfloat16>::value;
  constexpr bool BF = F::BF;

  extern __shared__ __align__(16) uint8_t rsm[];
  KVT* kv_s = reinterpret_cast<KVT*>(rsm);       // [2][K, V][KT][PITCH]
  __shared__ int32_t kpos_s[META][KT];
  __shared__ int64_t koff_s[PAGED ? META : 1][KT];
  __shared__ int64_t voff_s[PAGED ? META : 1][KT];

  const int R = p.T * p.G;
  // grid (row tiles x n_split, H, B), the row tiles in reverse: the
  // blocks of the last rows, which see the most keys, start first
  const int n_rt = (R + ROWS - 1) / ROWS;
  const int rank = blockIdx.x % p.n_split;
  const int r0 = (n_rt - 1 - static_cast<int>(blockIdx.x) / p.n_split) * ROWS;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;        // fragment coordinates
  const int slot = PAGED ? 0 : (p.slot_idx ? p.slot_idx[b] : b);
  const int32_t* btab = PAGED ? p.block_table + b * p.bt_sb : nullptr;
  const int32_t* kp = p.k_pos + (PAGED ? 0 : slot * p.kpos_sp);
  const KVT* kb = static_cast<const KVT*>(p.k) + h * p.k_sh +
                  (PAGED ? 0 : slot * p.k_sp);
  const KVT* vb = static_cast<const KVT*>(p.v) + h * p.v_sh +
                  (PAGED ? 0 : slot * p.v_sp);

  // this block's tiles: spans rank, rank + n_split, ... of span_tiles
  // tiles (as partial_kernel)
  const int n_tiles = (p.S + KT - 1) / KT;
  const int span = p.span_tiles;
  int nt = 0;
  for (int j = rank; j * span < n_tiles; j += p.n_split)
    nt += min(span, n_tiles - j * span);
  auto tile_of = [&](int i) {
    return (rank + p.n_split * (i / span)) * span + i % span;
  };

  // this warp's rows: wr + gq and wr + gq + 8 (x = 0, 1)
  const int wr = r0 + 16 * warp;
  const bool has_rows = wr < R;
  bool row_ok[2];
  int qpos[2];
  const uint8_t* mrow[2];
  const QT* qrow[2];
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    const int r = wr + gq + 8 * x;
    row_ok[x] = r < R;
    const int t = row_ok[x] ? r / p.G : 0;
    qpos[x] = row_ok[x] ? p.q_pos[b * p.qpos_sb + t] : 0;
    mrow[x] = (p.mask != nullptr && row_ok[x])
                  ? p.mask + b * p.mask_sb + t * p.mask_st
                  : nullptr;
    qrow[x] = static_cast<const QT*>(p.q) + b * p.q_sb + h * p.q_sh +
              (row_ok[x] ? t * p.q_st + (r % p.G) * p.q_sg : 0);
  }
  // q as A fragments for the whole key loop. TF32 (f32 K/V): the raw
  // bits of q at k-step m, (row gq + 8 x, column 8 m + tq + 4 hf) in
  // register 2 hf + x, split per use. bf16 K/V: bf16 halves (hi, lo) of
  // columns 16 m + 2 tq (+ 1) and 16 m + 8 + 2 tq (+ 1), zero past D.
  constexpr int QA = BF ? 1 : D / 8, QB = BF ? DS / 16 : 1;
  uint32_t qa[QA][4], qh[QB][4], ql[QB][4];
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    if constexpr (BF) {
#pragma unroll
      for (int m = 0; m < QB; ++m) {
        float v[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int d = 16 * m + 8 * (e >> 1);
          v[e] = row_ok[x] && d < D
                     ? to_f32(qrow[x][d + 2 * tq + (e & 1)]) : 0.f;
        }
        bf16_pair(v[0], v[1], qh[m][x], ql[m][x]);
        bf16_pair(v[2], v[3], qh[m][2 + x], ql[m][2 + x]);
      }
    } else {
#pragma unroll
      for (int m = 0; m < QA; ++m)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
          qa[m][2 * hf + x] =
              row_ok[x] ? ld_bits(qrow[x] + 8 * m + tq + 4 * hf) : 0u;
    }
  }

  // warp 0 tests tiles for live keys: the block's query-position range
  int qmin = 2147483647, qmax = -2147483647 - 1;
  if (warp == 0) {
#pragma unroll
    for (int rr = lane; rr < ROWS; rr += 32) {
      if (r0 + rr < R) {
        const int qp = p.q_pos[b * p.qpos_sb + (r0 + rr) / p.G];
        qmin = min(qmin, qp);
        qmax = max(qmax, qp);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      qmin = min(qmin, __shfl_xor_sync(0xffffffffu, qmin, off));
      qmax = max(qmax, __shfl_xor_sync(0xffffffffu, qmax, off));
    }
  }
  auto live_key = [&](int32_t kpos) {
    return kpos >= 0 && (!p.causal || kpos <= qmax) &&
           (p.window <= 0 || qmin - kpos < p.window);
  };

  // key metadata of tile i, for thread tid < KT (as partial_kernel)
  auto block_page = [&](int i) -> int32_t {
    const int s = tile_of(i) * KT + tid;
    return (i < nt && s < p.S) ? btab[s / p.page_size] : 0;
  };
  auto load_meta = [&](int i, int32_t page) -> KeyMeta {
    KeyMeta km{-1, 0, 0};
    const int s = tile_of(i) * KT + tid;
    if (i < nt && s < p.S) {
      const int64_t prow = PAGED ? page : slot;
      const int64_t rw = PAGED ? s % p.page_size : s;
      if constexpr (PAGED) {
        km.pos = kp[prow * p.kpos_sp + rw];
        km.koff = prow * p.k_sp + rw * p.k_ss;
        km.voff = prow * p.v_sp + rw * p.v_ss;
      } else {
        km.pos = kp[s];
      }
    }
    return km;
  };
  auto store_meta = [&](int i, const KeyMeta& km) {
    kpos_s[i % META][tid] = km.pos;
    if constexpr (PAGED) {
      koff_s[i % META][tid] = km.koff;
      voff_s[i % META][tid] = km.voff;
    }
  };
  // the 16-byte copies of tile i's K and V rows (rows past S zero-filled)
  auto copy_tile = [&](int i) {
    KVT* ks = kv_s + (i & 1) * 2 * TILE;
    KVT* vs = ks + TILE;
    const int s0 = tile_of(i) * KT;
    constexpr int EPC = 16 / int(sizeof(KVT)), CPR = F::CPR;
    for (int c = tid; c < KT * CPR; c += THREADS) {
      const int j = c / CPR, e0 = (c % CPR) * EPC;
      const int s = s0 + j;
      const bool in = s < p.S;
      int64_t ko, vo;
      if constexpr (PAGED) {
        ko = koff_s[i % META][j];
        vo = voff_s[i % META][j];
      } else {
        ko = static_cast<int64_t>(s) * p.k_ss;
        vo = static_cast<int64_t>(s) * p.v_ss;
      }
      cp_async16(ks + j * PITCH + e0, in ? kb + ko + e0 : kb, in ? 16 : 0);
      cp_async16(vs + j * PITCH + e0, in ? vb + vo + e0 : vb, in ? 16 : 0);
    }
  };

  // O: rows gq (+ 8), columns 8 n + 2 tq (+ 1)
  float o[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m_run[2] = {NEG_INF, NEG_INF};
  float l_run[2] = {0.f, 0.f};

  if constexpr (DS != D) {
    // bf16 D 120: staged columns 120-127 of every row of both buffers are
    // zeros, written once (the copies fill the first D columns only)
    static_assert((DS - D) * int(sizeof(KVT)) == 16, "one store a row");
    for (int r = tid; r < 4 * KT; r += THREADS)
      *reinterpret_cast<uint4*>(kv_s + r * PITCH + D) =
          make_uint4(0u, 0u, 0u, 0u);
  }

  // prologue: metadata of tiles 0 and 1, the copy of tile 0
  int32_t page_next = 0;   // paged: block-table entry of tile i + 2
  int live0 = 0, live1 = 0;
  if (tid < KT) {
    int32_t pg0 = 0, pg1 = 0;
    if constexpr (PAGED) {
      pg0 = block_page(0);
      pg1 = block_page(1);
      page_next = block_page(2);
    }
    const KeyMeta a = load_meta(0, pg0), c1 = load_meta(1, pg1);
    store_meta(0, a);
    store_meta(1, c1);
    live0 = 0 < nt && live_key(a.pos);
    live1 = 1 < nt && live_key(c1.pos);
  }
  int cur_live = __syncthreads_or(live0);
  int next_live = __syncthreads_or(live1);
  if (cur_live) copy_tile(0);
  asm volatile("cp.async.commit_group;\n" ::);

  for (int i = 0; i < nt; ++i) {
    // the copy of tile i + 1 (its buffer was consumed at step i - 1)
    if (next_live) copy_tile(i + 1);
    asm volatile("cp.async.commit_group;\n" ::);
    // metadata of tile i + 2 (and the page of tile i + 3) in flight
    KeyMeta ahead{-1, 0, 0};
    if (tid < KT) {
      ahead = load_meta(i + 2, page_next);
      if constexpr (PAGED) page_next = block_page(i + 3);
    }
    asm volatile("cp.async.wait_group 1;\n" ::);
    __syncthreads();

    if (cur_live && has_rows) {
      const KVT* ks = kv_s + (i & 1) * 2 * TILE;
      const KVT* vs = ks + TILE;
      const int32_t* kpos_t = kpos_s[i % META];
      const int s0 = tile_of(i) * KT;
      // ---- S = q·Kᵀ: n-tile j holds keys 8 j + 2 tq (+ 1), rows gq (+ 8)
      float sv[NJ][4];
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sv[j][e] = 0.f;
      if constexpr (BF) {
        // K's B fragments by `ldmatrix` (two n-tiles a load); the lo
        // product first
        const uint8_t* krow = reinterpret_cast<const uint8_t*>(ks) +
                              ((lane & 7) + ((lane >> 4) << 3)) * PB +
                              ((lane >> 3) & 1) * 16;
#pragma unroll
        for (int m = 0; m < QB; ++m) {
#pragma unroll
          for (int jp = 0; jp < NJ / 2; ++jp) {
            uint32_t bq[4];
            ldmatrix_x4<false>(bq, krow + 16 * jp * PB + 32 * m);
            const uint32_t b0[2] = {bq[0], bq[1]}, b1[2] = {bq[2], bq[3]};
            if (!QEX) {
              mma_bf16(sv[2 * jp], ql[m], b0);
              mma_bf16(sv[2 * jp + 1], ql[m], b1);
            }
            mma_bf16(sv[2 * jp], qh[m], b0);
            mma_bf16(sv[2 * jp + 1], qh[m], b1);
          }
        }
      } else {
        // 3xTF32: B b0 (k tq, key gq), b1 (k tq + 4, key gq) of n-tile j
        const KVT* kr = ks + gq * PITCH + tq;
#pragma unroll
        for (int m = 0; m < QA; ++m) {
          uint32_t ah[4], al[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) tf32_split<QEX>(qa[m][e], ah[e], al[e]);
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
            uint32_t bh[2], bl[2];
            tf32_split<false>(ld_bits(kr + 8 * j * PITCH + 8 * m), bh[0],
                              bl[0]);
            tf32_split<false>(ld_bits(kr + 8 * j * PITCH + 8 * m + 4),
                              bh[1], bl[1]);
            if (!QEX) mma_tf32(sv[j], al, bh);
            mma_tf32(sv[j], ah, bl);
            mma_tf32(sv[j], ah, bh);
          }
        }
      }
      // ---- online softmax over the tile's 32 keys: the GQA form's
      // arithmetic, a row's state in its 4 lanes
      bool ok[NJ][4];
      float tmax[2] = {NEG_INF, NEG_INF};
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int x = e >> 1;
          const int kj = 8 * j + 2 * tq + (e & 1);
          const int kpos = kpos_t[kj];
          bool valid = row_ok[x] && kpos >= 0;
          if (p.causal) valid = valid && kpos <= qpos[x];
          if (p.window > 0) valid = valid && (qpos[x] - kpos < p.window);
          if (mrow[x] != nullptr)
            valid = valid && s0 + kj < p.S && mrow[x][s0 + kj] != 0;
          const float sc = valid ? sv[j][e] * p.scale : NEG_INF;
          sv[j][e] = sc;
          ok[j][e] = valid;
          tmax[x] = fmaxf(tmax[x], sc);
        }
      }
      float corr[2];
#pragma unroll
      for (int x = 0; x < 2; ++x) {
#pragma unroll
        for (int off = 1; off < 4; off <<= 1)
          tmax[x] = fmaxf(tmax[x], __shfl_xor_sync(0xffffffffu, tmax[x], off));
        const float m_new = fmaxf(m_run[x], tmax[x]);
        float psum = 0.f;
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int e = 2 * x; e < 2 * x + 2; ++e) {
            sv[j][e] = ok[j][e] ? expf(sv[j][e] - m_new) : 0.f;
            psum += sv[j][e];
          }
#pragma unroll
        for (int off = 1; off < 4; off <<= 1)
          psum += __shfl_xor_sync(0xffffffffu, psum, off);
        corr[x] = expf(m_run[x] - m_new);
        l_run[x] = l_run[x] * corr[x] + psum;
        m_run[x] = m_new;
      }
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        o[n][0] *= corr[0];
        o[n][1] *= corr[0];
        o[n][2] *= corr[1];
        o[n][3] *= corr[1];
      }
      // ---- O += P·V, P from the score registers
      if constexpr (BF) {
        // two 16-key steps: P's A fragments are n-tiles 2 kk and 2 kk + 1
        // in bf16 halves; V's B fragments by `ldmatrix.trans` (two n-tiles
        // a load, the fifteenth of D 120 alone)
        const uint8_t* vrow = reinterpret_cast<const uint8_t*>(vs) +
                              ((lane & 7) + ((lane >> 3) & 1) * 8) * PB +
                              (lane >> 4) * 16;
#pragma unroll
        for (int kk = 0; kk < NJ / 2; ++kk) {
          uint32_t ah[4], al[4];
          bf16_pair(sv[2 * kk][0], sv[2 * kk][1], ah[0], al[0]);
          bf16_pair(sv[2 * kk][2], sv[2 * kk][3], ah[1], al[1]);
          bf16_pair(sv[2 * kk + 1][0], sv[2 * kk + 1][1], ah[2], al[2]);
          bf16_pair(sv[2 * kk + 1][2], sv[2 * kk + 1][3], ah[3], al[3]);
#pragma unroll
          for (int np = 0; np < NT / 2; ++np) {
            uint32_t bv[4];
            ldmatrix_x4<true>(bv, vrow + 16 * kk * PB + 32 * np);
            const uint32_t b0[2] = {bv[0], bv[1]}, b1[2] = {bv[2], bv[3]};
            mma_bf16(o[2 * np], al, b0);
            mma_bf16(o[2 * np], ah, b0);
            mma_bf16(o[2 * np + 1], al, b1);
            mma_bf16(o[2 * np + 1], ah, b1);
          }
          if constexpr (NT % 2 != 0) {
            uint32_t bv[2];
            ldmatrix_b(bv, reinterpret_cast<const __nv_bfloat16*>(
                               reinterpret_cast<const uint8_t*>(vs) +
                               (lane % 16 + 16 * kk) * PB + 16 * (NT - 1)));
            mma_bf16(o[NT - 1], al, bv);
            mma_bf16(o[NT - 1], ah, bv);
          }
        }
      } else {
        // four 8-key steps of 3xTF32: k = tq is key 8 kk + 2 tq and k =
        // tq + 4 key 8 kk + 2 tq + 1, so a thread's A values are its own
        // scores (rows gq, gq + 8); V's b0 (key 8 kk + 2 tq, column 8 n +
        // gq), b1 (the next key)
#pragma unroll
        for (int kk = 0; kk < NJ; ++kk) {
          uint32_t ah[4], al[4];
          tf32_split<false>(__float_as_uint(sv[kk][0]), ah[0], al[0]);
          tf32_split<false>(__float_as_uint(sv[kk][2]), ah[1], al[1]);
          tf32_split<false>(__float_as_uint(sv[kk][1]), ah[2], al[2]);
          tf32_split<false>(__float_as_uint(sv[kk][3]), ah[3], al[3]);
          const KVT* v0 = vs + (8 * kk + 2 * tq) * PITCH + gq;
#pragma unroll
          for (int n = 0; n < NT; ++n) {
            uint32_t bh[2], bl[2];
            tf32_split<false>(ld_bits(v0 + 8 * n), bh[0], bl[0]);
            tf32_split<false>(ld_bits(v0 + PITCH + 8 * n), bh[1], bl[1]);
            mma_tf32(o[n], al, bh);
            mma_tf32(o[n], ah, bl);
            mma_tf32(o[n], ah, bh);
          }
        }
      }
    }

    // metadata of tile i + 2 lands; every thread is done with buffer i & 1
    int live2 = 0;
    if (tid < KT) {
      store_meta(i + 2, ahead);
      live2 = i + 2 < nt && live_key(ahead.pos);
    }
    const int l2 = __syncthreads_or(live2);
    cur_live = next_live;
    next_live = l2;
  }
  asm volatile("cp.async.wait_group 0;\n" ::);

  auto out_row = [&](int r) -> int64_t {
    return ((static_cast<int64_t>(b) * p.T + r / p.G) * p.H + h) * p.G +
           r % p.G;
  };
  if (p.n_split == 1) {   // straight from registers
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      const int r = wr + gq + 8 * x;
      if (!row_ok[x]) continue;
      float* dst = p.acc + out_row(r) * D + 2 * tq;
#pragma unroll
      for (int n = 0; n < NT; ++n)
        *reinterpret_cast<float2*>(dst + 8 * n) =
            make_float2(o[n][2 * x], o[n][2 * x + 1]);
      if (tq == 0) {
        p.m[out_row(r)] = m_run[x];
        p.l[out_row(r)] = l_run[x];
      }
    }
    return;
  }
  // the block partial into shared memory (the staging buffers are free),
  // rows of [ROWS][D], for the cluster's fold
  __syncthreads();
  float* part = reinterpret_cast<float*>(rsm);    // [ROWS][D]
  float* part_m = part + ROWS * D;                // [ROWS]
  float* part_l = part_m + ROWS;
  float* fac = part_l + ROWS;                     // [ROWS][MAX_SPLIT][2]
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    const int pr = 16 * warp + gq + 8 * x;
    float* dst = part + pr * D + 2 * tq;
#pragma unroll
    for (int n = 0; n < NT; ++n)
      *reinterpret_cast<float2*>(dst + 8 * n) =
          make_float2(o[n][2 * x], o[n][2 * x + 1]);
    if (tq == 0) {
      part_m[pr] = m_run[x];
      part_l[pr] = l_run[x];
    }
  }

  // ---- the cluster's n_split block partials in rank order (as the int8
  // and latent forms): each row's fold once, then each rank its share of
  // the rows' columns, four at a time
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  if (tid < ROWS && r0 + tid < R) {
    float mq[MAX_SPLIT], lq[MAX_SPLIT];   // every remote load in flight
#pragma unroll
    for (int q = 0; q < MAX_SPLIT; ++q) {
      mq[q] = q < p.n_split ? cluster.map_shared_rank(part_m, q)[tid] : 0.f;
      lq[q] = q < p.n_split ? cluster.map_shared_rank(part_l, q)[tid] : 0.f;
    }
    float m_a = mq[0], l_a = lq[0];
#pragma unroll
    for (int q = 1; q < MAX_SPLIT; ++q) {
      if (q < p.n_split) {
        const float mm = fmaxf(m_a, mq[q]);
        const float ea = expf(m_a - mm), eb = expf(mq[q] - mm);
        l_a = l_a * ea + lq[q] * eb;
        m_a = mm;
        fac[(tid * MAX_SPLIT + q) * 2] = ea;
        fac[(tid * MAX_SPLIT + q) * 2 + 1] = eb;
      }
    }
    if (rank == 0) {
      p.m[out_row(r0 + tid)] = m_a;
      p.l[out_row(r0 + tid)] = l_a;
    }
  }
  __syncthreads();
  for (int e = rank * THREADS + tid; e < ROWS * D / 4;
       e += p.n_split * THREADS) {
    const int rr = e / (D / 4), d = 4 * (e % (D / 4));
    if (r0 + rr >= R) continue;
    float4 aq[MAX_SPLIT];
#pragma unroll
    for (int q = 0; q < MAX_SPLIT; ++q)
      aq[q] = q < p.n_split
                  ? *reinterpret_cast<const float4*>(
                        cluster.map_shared_rank(part, q) + rr * D + d)
                  : make_float4(0.f, 0.f, 0.f, 0.f);
    float4 a_a = aq[0];
#pragma unroll
    for (int q = 1; q < MAX_SPLIT; ++q) {
      if (q < p.n_split) {
        const float ea = fac[(rr * MAX_SPLIT + q) * 2];
        const float eb = fac[(rr * MAX_SPLIT + q) * 2 + 1];
        a_a.x = a_a.x * ea + aq[q].x * eb;
        a_a.y = a_a.y * ea + aq[q].y * eb;
        a_a.z = a_a.z * ea + aq[q].z * eb;
        a_a.w = a_a.w * ea + aq[q].w * eb;
      }
    }
    *reinterpret_cast<float4*>(p.acc + out_row(r0 + rr) * D + d) = a_a;
  }
  cluster.sync();   // no block leaves while another reads its partials
}

template <int D, typename QT, typename KVT, bool PAGED>
int launch_rows(const Params& p, int B, cudaStream_t stream) {
  using F = RowsForm<D, KVT>;
  if (p.n_split > F::MAX_SPLIT)
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = rows_kernel<D, QT, KVT, PAGED>;
  constexpr int smem = F::BYTES;
  static bool attr = false;   // one flag per instantiation
  if (!attr) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         smem);
    cudaFuncSetAttribute(kernel,
                         cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    attr = true;
  }
  const int R = p.T * p.G;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(((R + F::ROWS - 1) / F::ROWS) * p.n_split, p.H, B);
  cfg.blockDim = dim3(F::THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attrs[1];
  attrs[0].id = cudaLaunchAttributeClusterDimension;
  attrs[0].val.clusterDim.x = p.n_split;
  attrs[0].val.clusterDim.y = 1;
  attrs[0].val.clusterDim.z = 1;
  cfg.attrs = attrs;
  cfg.numAttrs = p.n_split > 1 ? 1 : 0;
  return static_cast<int>(cudaLaunchKernelEx(&cfg, kernel, p));
}

// K/V storage: the `kv` argument of the entry points
constexpr int KV_F32 = 0, KV_BF16 = 1, KV_INT8 = 2;

template <int DK, int DV, typename QT, bool PAGED>
int dispatch_kv(const Params& p, int B, int kv, int row_tile,
                cudaStream_t stream) {
  if constexpr (DK != DV) {   // the latent form: f32 or bf16 K/V
    if (row_tile != LatentForm<DK, DV>::ROWS)
      return static_cast<int>(cudaErrorInvalidValue);
    switch (kv) {
      case KV_F32:
        return launch_latent<DK, DV, QT, float, PAGED>(p, B, stream);
      case KV_BF16:
        return launch_latent<DK, DV, QT, __nv_bfloat16, PAGED>(p, B, stream);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  } else {
    if (kv != KV_INT8 && row_tile != ROWS) {   // the many-row form
      if constexpr (rows_form(DK)) {
        if (row_tile == RowsForm<DK, float>::ROWS && kv == KV_F32)
          return launch_rows<DK, QT, float, PAGED>(p, B, stream);
        if (row_tile == RowsForm<DK, float>::ROWS && kv == KV_BF16)
          return launch_rows<DK, QT, __nv_bfloat16, PAGED>(p, B, stream);
      }
      return static_cast<int>(cudaErrorInvalidValue);
    }
    switch (kv) {
      case KV_F32: return launch<DK, DV, QT, float, PAGED>(p, B, stream);
      case KV_BF16:
        return launch<DK, DV, QT, __nv_bfloat16, PAGED>(p, B, stream);
      case KV_INT8: return launch_int8<DK, QT, PAGED>(p, B, row_tile, stream);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
}

template <int DK, int DV, bool PAGED>
int dispatch_dtypes(const Params& p, int B, int q_bf16, int kv, int row_tile,
                    cudaStream_t stream) {
  return q_bf16 ? dispatch_kv<DK, DV, __nv_bfloat16, PAGED>(p, B, kv,
                                                             row_tile, stream)
                : dispatch_kv<DK, DV, float, PAGED>(p, B, kv, row_tile,
                                                    stream);
}

// The instantiated head widths (Dk, Dv): `ops.py::SUPPORTED_PAIRS`.
#define ATTN_PARTIAL_PAIRS(X) \
  X(16, 16) X(32, 32) X(64, 64) X(120, 120) X(128, 128) X(40, 32) \
  X(576, 512)

// Launch on `stream` for head widths (Dk, Dv) of ATTN_PARTIAL_PAIRS and
// K/V storage `kv` (KV_F32, KV_BF16, or KV_INT8 with scales where Dk ==
// Dv), `row_tile` query rows a block (`ops.py::tiling`: the GQA form's
// 16, the many-row form's 64 (f32 / bf16 K/V at D 64, 120, 128), the
// latent form's 64, the int8 form's 16 or 64); returns the launch's
// error (cudaErrorInvalidValue for another pair, kv, row tile or
// n_split).
template <bool PAGED>
int dispatch(const Params& p, int B, int DK, int DV, int q_bf16, int kv,
             int row_tile, cudaStream_t stream) {
  if (p.n_split < 1 || p.span_tiles < 1)
    return static_cast<int>(cudaErrorInvalidValue);
#define PAIR_CASE(DK_, DV_)                                           \
  if (DK == DK_ && DV == DV_)                                         \
    return dispatch_dtypes<DK_, DV_, PAGED>(p, B, q_bf16, kv, row_tile, \
                                            stream);
  ATTN_PARTIAL_PAIRS(PAIR_CASE)
#undef PAIR_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

template <int DK, int DV, typename QT, typename KVT, bool PAGED>
int smem_kv(int row_tile, int* dynamic, int* static_bytes, int* limit) {
  if constexpr (DK != DV) {
    return smem_report(latent_kernel<DK, DV, QT, KVT, PAGED>,
                       LatentSmem<DK, DV, QT, KVT>::BYTES, dynamic,
                       static_bytes, limit);
  } else {
    if (row_tile == ROWS)
      return smem_report(partial_kernel<DK, DV, QT, KVT, PAGED>,
                         kv_smem_bytes<DK, DV, KVT>(), dynamic, static_bytes,
                         limit);
    if constexpr (rows_form(DK)) {
      if (row_tile == RowsForm<DK, KVT>::ROWS)
        return smem_report(rows_kernel<DK, QT, KVT, PAGED>,
                           RowsForm<DK, KVT>::BYTES, dynamic, static_bytes,
                           limit);
    }
    return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <int DK, int DV, typename QT, bool PAGED>
int smem_of(int kv, int row_tile, int* dynamic, int* static_bytes,
            int* limit) {
  switch (kv) {
    case KV_F32:
      return smem_kv<DK, DV, QT, float, PAGED>(row_tile, dynamic,
                                               static_bytes, limit);
    case KV_BF16:
      return smem_kv<DK, DV, QT, __nv_bfloat16, PAGED>(row_tile, dynamic,
                                                       static_bytes, limit);
    case KV_INT8:
      if constexpr (DK == DV)
        return smem_report(int8_kernel<DK, QT, PAGED>, Int8Form<DK>::BYTES,
                           dynamic, static_bytes, limit);
      return static_cast<int>(cudaErrorInvalidValue);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Shared memory of the instantiation for head widths (Dk, Dv), these
// dtypes and, for f32 / bf16 K/V at Dk == Dv, the row tile that picks
// the form (`ops.py::tiling`: 16 the GQA form, 64 the many-row form;
// the int8 and latent forms ignore it) (see smem_report.cuh).
template <bool PAGED>
int smem(int DK, int DV, int q_bf16, int kv, int row_tile, int* dynamic,
         int* static_bytes, int* limit) {
#define PAIR_CASE(DK_, DV_)                                                \
  if (DK == DK_ && DV == DV_)                                              \
    return q_bf16 ? smem_of<DK_, DV_, __nv_bfloat16, PAGED>(               \
                        kv, row_tile, dynamic, static_bytes, limit)        \
                  : smem_of<DK_, DV_, float, PAGED>(kv, row_tile, dynamic, \
                                                    static_bytes, limit);
  ATTN_PARTIAL_PAIRS(PAIR_CASE)
#undef PAIR_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace attn_partial
