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
// Two forms share the body, fixed by the head widths (Dk, Dv):
//   * Dk == Dv in {16, 32, 64, 128}: GQA heads (f32, bf16 or int8 K/V).
//   * Dk != Dv, the latent form: MLA's absorbed attention (DeepSeek-V3:
//     one KV head holding c_kv ++ k_pe, Dk = 512 + 64 = 576, Dv = 512,
//     all 128 query heads folded onto it as G = 128 rows a token), and a
//     tiny pair (40, 32) for tests; f32 or bf16 K/V. Its tiles are 16
//     keys (a double-buffered f32 tile of 576 + 512 values a key is
//     136 KB; 32 keys would be 272 KB, above a block's 227 KB), 16
//     threads share a query row at Dk > 128 (each keeps a 36-value q
//     strip and a 32-value acc strip in registers), and a cluster splits
//     keys over at most 8 blocks (a portable cluster: one such block
//     fills an SM's shared memory). K and V are staged separately: the
//     kernel reads `v` as given, although MLA writes V as the first 512
//     columns of K.
//
// What bounds it on the H100: at decode, verification's cache pass and
// commit (a handful of query rows per KV head) it reads each K/V byte of
// the keys a request holds once for a few rows: bound by those bytes over
// 3.35 TB/s, a few microseconds, so latency decides — how many blocks
// share the keys and how many round trips to HBM each block waits for.
// Only the 512-row prefill has enough rows per key to approach the f32
// FMA rate. The latent form has 128 rows a token on its one KV head: at
// decode each of a token's 8 row tiles reads the request's whole latent
// cache (about 8x the bytes bound; sharing a tile over all 128 heads is
// ROADMAP queue 2's latent-form entry).
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
//   * Pipelined tiles. K/V tiles are staged in their stored dtype (f32,
//     bf16 or int8) with 16-byte `cp.async` copies into a double buffer, so the
//     copy of tile t + 1 overlaps the arithmetic of tile t; values become
//     f32 where they are used. A tile's key positions (and, paged, its
//     rows' page offsets) are read two tiles ahead (the block-table entry
//     three ahead), so each tile's copy is issued before the previous
//     tile is computed. A tile whose positions no query row of the block
//     can see (empty slots, unmapped or NULL pages, keys above the causal
//     diagonal or out of the window) is not copied at all
//     (`__syncthreads_or`): a request reads only the K/V it holds, and
//     skipping is bit-exact (every p = 0, the correction exp(0) = 1).
//   * int8 K/V (the `kv_dtype="int8"` caches). Tiles are staged as
//     int8, D bytes a key row, by the same 16-byte `cp.async` copies (a
//     quarter of f32's bytes); each key's f32 scale for this head, one
//     per (row, head), is read with the key's metadata two tiles ahead
//     and kept beside it in shared memory. Once a tile has landed, the
//     block dequantizes it in one pass into a bf16 tile in shared memory,
//     exactly bf16(f32(k8) * scale): the reference's dequantized view
//     (`dequantize_cache`) element for element, so the int8 form and its
//     plain version differ only in summation order. The arithmetic then
//     reads that tile as the bf16 form reads its own. (Dequantizing in
//     each query row's registers instead repeats the conversion for all
//     16 rows of a block and was 2-3.7x slower on the H100.) The scale is
//     not folded into the dot product ((q . k8) * scale), which would be
//     another function.
//   * f32 on CUDA cores. TPR threads (8, or 16 at Dk > 128) share a query
//     row; each keeps its strip of Dk/TPR of q in registers and scores
//     every key of a tile over that strip (one shared-memory read per
//     FMA, broadcast to the warp's rows), then a fixed butterfly over the
//     row's lanes hands each lane the full dot products of KT/TPR keys.
//     Strips are interleaved in chunks of up to 16 bytes (lane + TPR c),
//     so a row's reads cover contiguous bytes.
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

constexpr int ROWS = 16;            // query rows per block
constexpr int META = 3;             // tiles of key metadata in flight
constexpr float NEG_INF = -1e30f;

// The tiling of the form for head widths (DK, DV): see the top of the
// file. `ops.py::tiling` mirrors KT and MAX_SPLIT.
template <int DK, int DV>
struct Form {
  static constexpr bool LATENT = DK != DV;
  static constexpr int KT = LATENT ? 16 : 32;        // keys per tile
  static constexpr int TPR = DK > 128 ? 16 : 8;      // threads per row
  static constexpr int THREADS = ROWS * TPR;
  static constexpr int KPT = KT / TPR;               // keys per lane
  static constexpr int MAX_SPLIT = LATENT ? 8 : 16;  // blocks a cluster
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

// An int8 tile (its K rows, then its V rows: 2 x KT x D values) as its
// bf16 view bf16(f32(x8) * scale), written once by the whole block: the
// reference's dequantized view bit for bit (the f32 product is exact
// IEEE, the bf16 conversion rounds to nearest even, as torch and XLA).
// int8 -> f32 by the exponent trick (bias the byte to unsigned, place
// it in the mantissa of 2^23, subtract 2^23 + 128), which needs no
// conversion unit.
template <int D, int KT, int THREADS>
__device__ __forceinline__ void dequant_tile(const int8_t* src,
                                             __nv_bfloat16* dst,
                                             const float* k_sc,
                                             const float* v_sc, int tid) {
  constexpr int VALS = KT * D;
  for (int e = 4 * tid; e < 2 * VALS; e += 4 * THREADS) {
    const int j = (e % VALS) / D;
    const float sc = e < VALS ? k_sc[j] : v_sc[j];
    const uint32_t w = *reinterpret_cast<const uint32_t*>(src + e) ^
                       0x80808080u;
    float f[4];
#pragma unroll
    for (int b = 0; b < 4; ++b)
      f[b] = (__uint_as_float(__byte_perm(w, 0x4B000000u, 0x7650 + b)) -
              8388736.f) * sc;
    const __nv_bfloat162 lo = __floats2bfloat162_rn(f[0], f[1]);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(f[2], f[3]);
    *reinterpret_cast<uint2*>(dst + e) =
        make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                   *reinterpret_cast<const uint32_t*>(&hi));
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

// One key's metadata, read by thread `j` (< KT) of the block: position,
// pool-row offsets of K and V (element offsets from the head's base) and,
// int8, the key's K and V scales for this head.
struct KeyMeta {
  int32_t pos;
  int64_t koff, voff;
  float ksc, vsc;
};

template <int DK, int DV, typename QT, typename KVT, bool PAGED>
__global__ void __launch_bounds__(Form<DK, DV>::THREADS)
partial_kernel(const Params p) {
  using F = Form<DK, DV>;
  constexpr int KT = F::KT, TPR = F::TPR, THREADS = F::THREADS;
  constexpr int KPT = F::KPT, MAX_SPLIT = F::MAX_SPLIT;
  constexpr bool Q8 = std::is_same<KVT, int8_t>::value;
  static_assert(!Q8 || DK == DV, "int8 K/V only in the Dk == Dv form");
  // the tiles the arithmetic reads: int8 K/V through their bf16 view
  using CT = typename std::conditional<Q8, __nv_bfloat16, KVT>::type;
  constexpr int CVK = chunk_vals(DK / TPR, 16 / int(sizeof(CT)));
  constexpr int NCHK = DK / TPR / CVK;               // q chunks per thread
  constexpr int CVV = chunk_vals(DV / TPR, 16 / int(sizeof(CT)));
  constexpr int NCHV = DV / TPR / CVV;               // acc chunks
  constexpr int TILE_K = KT * DK;                    // elements per tile
  constexpr int TILE_V = KT * DV;
  constexpr int CPK = DK * int(sizeof(KVT)) / 16;    // 16 B copies a key
  constexpr int CPV = DV * int(sizeof(KVT)) / 16;

  extern __shared__ __align__(16) uint8_t kv_smem[];
  KVT* kv_s = reinterpret_cast<KVT*>(kv_smem);       // [2][K, V][KT][D]
  // int8: the current tile's bf16 view, [K, V][KT][D], after the staging
  CT* dq_s = reinterpret_cast<CT*>(kv_smem +
                                   2 * (TILE_K + TILE_V) * sizeof(KVT));
  __shared__ int32_t kpos_s[META][KT];
  __shared__ int64_t koff_s[PAGED ? META : 1][KT];
  __shared__ int64_t voff_s[PAGED ? META : 1][KT];
  __shared__ float ksc_s[Q8 ? META : 1][KT];         // int8: key scales
  __shared__ float vsc_s[Q8 ? META : 1][KT];
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
    KeyMeta km{-1, 0, 0, 0.f, 0.f};
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
      if constexpr (Q8) {
        km.ksc = p.k_scale[prow * p.ksc_sp + rw * p.ksc_ss + h * p.ksc_sh];
        km.vsc = p.v_scale[prow * p.vsc_sp + rw * p.vsc_ss + h * p.vsc_sh];
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
    if constexpr (Q8) {
      ksc_s[i % META][tid] = km.ksc;
      vsc_s[i % META][tid] = km.vsc;
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
    KeyMeta ahead{-1, 0, 0, 0.f, 0.f};
    if (tid < KT) {
      ahead = load_meta(i + 2, page_next);
      if constexpr (PAGED) page_next = block_page(i + 3);
    }
    asm volatile("cp.async.wait_group 1;\n" ::);
    __syncthreads();

    if (cur_live) {
      const CT* ks;
      if constexpr (Q8) {
        dequant_tile<DK, KT, THREADS>(kv_s + (i & 1) * (TILE_K + TILE_V),
                                      dq_s, ksc_s[i % META],
                                      vsc_s[i % META], tid);
        __syncthreads();
        ks = dq_s;
      } else {
        ks = kv_s + (i & 1) * (TILE_K + TILE_V);
      }
      const CT* vs = ks + TILE_K;
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

// the double-buffered staging tiles and, int8, the bf16 view of one tile
template <int DK, int DV, typename KVT>
constexpr int kv_smem_bytes() {
  constexpr int KT = Form<DK, DV>::KT;
  return 2 * KT * (DK + DV) * int(sizeof(KVT)) +
         (std::is_same<KVT, int8_t>::value ? KT * (DK + DV) * 2 : 0);
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

// K/V storage: the `kv` argument of the entry points
constexpr int KV_F32 = 0, KV_BF16 = 1, KV_INT8 = 2;

template <int DK, int DV, typename QT, bool PAGED>
int dispatch_kv(const Params& p, int B, int kv, cudaStream_t stream) {
  switch (kv) {
    case KV_F32: return launch<DK, DV, QT, float, PAGED>(p, B, stream);
    case KV_BF16:
      return launch<DK, DV, QT, __nv_bfloat16, PAGED>(p, B, stream);
    case KV_INT8:
      if constexpr (DK == DV) {
        if (p.k_scale == nullptr || p.v_scale == nullptr)
          return static_cast<int>(cudaErrorInvalidValue);
        return launch<DK, DV, QT, int8_t, PAGED>(p, B, stream);
      }
      return static_cast<int>(cudaErrorInvalidValue);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <int DK, int DV, bool PAGED>
int dispatch_dtypes(const Params& p, int B, int q_bf16, int kv,
                    cudaStream_t stream) {
  return q_bf16 ? dispatch_kv<DK, DV, __nv_bfloat16, PAGED>(p, B, kv, stream)
                : dispatch_kv<DK, DV, float, PAGED>(p, B, kv, stream);
}

// The instantiated head widths (Dk, Dv): `ops.py::SUPPORTED_PAIRS`.
#define ATTN_PARTIAL_PAIRS(X) \
  X(16, 16) X(32, 32) X(64, 64) X(128, 128) X(40, 32) X(576, 512)

// Launch on `stream` for head widths (Dk, Dv) of ATTN_PARTIAL_PAIRS and
// K/V storage `kv` (KV_F32, KV_BF16, or KV_INT8 with scales where Dk ==
// Dv); returns the launch's error (cudaErrorInvalidValue for another
// pair, kv or n_split).
template <bool PAGED>
int dispatch(const Params& p, int B, int DK, int DV, int q_bf16, int kv,
             cudaStream_t stream) {
  if (p.n_split < 1 || p.span_tiles < 1)
    return static_cast<int>(cudaErrorInvalidValue);
#define PAIR_CASE(DK_, DV_)                                           \
  if (DK == DK_ && DV == DV_)                                         \
    return dispatch_dtypes<DK_, DV_, PAGED>(p, B, q_bf16, kv, stream);
  ATTN_PARTIAL_PAIRS(PAIR_CASE)
#undef PAIR_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

template <int DK, int DV, typename QT, typename KVT, bool PAGED>
int smem_kv(int* dynamic, int* static_bytes, int* limit) {
  return smem_report(partial_kernel<DK, DV, QT, KVT, PAGED>,
                     kv_smem_bytes<DK, DV, KVT>(), dynamic, static_bytes,
                     limit);
}

template <int DK, int DV, typename QT, bool PAGED>
int smem_of(int kv, int* dynamic, int* static_bytes, int* limit) {
  switch (kv) {
    case KV_F32:
      return smem_kv<DK, DV, QT, float, PAGED>(dynamic, static_bytes, limit);
    case KV_BF16:
      return smem_kv<DK, DV, QT, __nv_bfloat16, PAGED>(dynamic, static_bytes,
                                                      limit);
    case KV_INT8:
      if constexpr (DK == DV)
        return smem_kv<DK, DV, QT, int8_t, PAGED>(dynamic, static_bytes,
                                                  limit);
      return static_cast<int>(cudaErrorInvalidValue);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Shared memory of the instantiation for head widths (Dk, Dv) and these
// dtypes (see smem_report.cuh).
template <bool PAGED>
int smem(int DK, int DV, int q_bf16, int kv, int* dynamic,
         int* static_bytes, int* limit) {
#define PAIR_CASE(DK_, DV_)                                                \
  if (DK == DK_ && DV == DV_)                                              \
    return q_bf16 ? smem_of<DK_, DV_, __nv_bfloat16, PAGED>(               \
                        kv, dynamic, static_bytes, limit)                  \
                  : smem_of<DK_, DV_, float, PAGED>(kv, dynamic,           \
                                                    static_bytes, limit);
  ATTN_PARTIAL_PAIRS(PAIR_CASE)
#undef PAIR_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace attn_partial
