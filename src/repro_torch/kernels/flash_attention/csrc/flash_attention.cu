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
// write every byte once more), in their stored dtype (f32 or bf16), by
// 16-byte `cp.async` copies into a double buffer and converted to f32
// where they are used. The logical keys of each (request, KV head, tile
// of 16 query rows) are split over a thread-block cluster of `n_split`
// blocks (flash-decoding), whose partials merge in fixed order through
// distributed shared memory, so decode's few rows still fill the SMs. A
// key tile whose positions no query row of the block can see (empty
// slots past a request's length, keys above the causal diagonal, keys
// out of the window) is never copied, so a request reads the K/V of the
// tokens it holds, not the slot's capacity. All GQA rows of a head share
// each tile. The running max, sum and the f32 accumulator stay in
// registers across the key loop (the Pallas kernel's VMEM scratch and
// sequential K grid axis become a loop inside the block); the
// arithmetic is f32 on CUDA cores. Reads of many query rows a KV head
// (R >= `ops.py::R_MMA`: prefill chunks, commits, cross reads of a
// frontend prefill, the Whisper encoder) run the many-row form
// (`rows_kernel` in the header): 64 rows a block share each 32-key tile
// and both products run on `mma.sync` (3xTF32 for f32 K/V; bf16 with q
// and P split into two bf16 halves for bf16 K/V), within the same 1e-4.
//
// int8 K/V (`kv_dtype="int8"` caches, an f32 scale per (row, head), every
// GQA head width) runs a kernel of its own in the header
// (`int8_kernel`): a ring of 8 int8
// tiles in flight, each tile converted once into the reference's bf16
// view, bf16(f32(k8) * scale), in shared memory by the warps that read
// it, both products on `mma.sync` bf16, and 16 or 64 query rows a block
// by R.
//
// MLA targets run its latent form (Dk = 576 != Dv = 512: the absorbed
// query over one KV head of c_kv ++ k_pe, G = 128 rows a token), a kernel
// of its own in the header (`latent_kernel`): 64 query rows share each
// 16-key tile, V is read out of K's tile when `v` is K's first 512
// columns (`v_in_k`), and both products run on tensor cores (`mma.sync`:
// 3xTF32 for f32 K/V, bf16 for bf16 K/V). The kernel body is
// `../../csrc/attention_partial.cuh`, shared with the paged-pool kernel; this file instantiates it for the resident slot pool
// and is its C entry point, which launches on the caller's stream,
// allocates nothing and returns cudaGetLastError().

#include "../../csrc/attention_partial.cuh"

extern "C" int fa_partial_launch(
    const void* q, const void* k, const void* v, const void* q_pos,
    const void* k_pos, const void* mask, const void* slot_idx,
    const void* k_scale, const void* v_scale, void* acc,
    void* m, void* l, int B, int T, int G, int H, int S, int Dk,
    int Dv,
    int64_t q_sb, int64_t q_st, int64_t q_sh, int64_t q_sg, int64_t k_sp,
    int64_t k_ss, int64_t k_sh, int64_t v_sp, int64_t v_ss, int64_t v_sh,
    int64_t ksc_sp, int64_t ksc_ss, int64_t ksc_sh, int64_t vsc_sp,
    int64_t vsc_ss, int64_t vsc_sh, int64_t kpos_sp, int64_t qpos_sb,
    int64_t mask_sb, int64_t mask_st, float scale, int causal, int window,
    int q_bf16, int kv, int n_split, int span_tiles, int v_in_k,
    int row_tile, void* stream) {
  attn_partial::Params p{};
  p.q = q;
  p.k = k;
  p.v = v;
  p.q_pos = static_cast<const int32_t*>(q_pos);
  p.k_pos = static_cast<const int32_t*>(k_pos);
  p.mask = static_cast<const uint8_t*>(mask);
  p.slot_idx = static_cast<const int32_t*>(slot_idx);
  p.block_table = nullptr;
  p.k_scale = static_cast<const float*>(k_scale);
  p.v_scale = static_cast<const float*>(v_scale);
  p.acc = static_cast<float*>(acc);
  p.m = static_cast<float*>(m);
  p.l = static_cast<float*>(l);
  p.T = T;
  p.G = G;
  p.H = H;
  p.S = S;
  p.page_size = 0;
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
  p.ksc_sp = ksc_sp;
  p.ksc_ss = ksc_ss;
  p.ksc_sh = ksc_sh;
  p.vsc_sp = vsc_sp;
  p.vsc_ss = vsc_ss;
  p.vsc_sh = vsc_sh;
  p.kpos_sp = kpos_sp;
  p.qpos_sb = qpos_sb;
  p.mask_sb = mask_sb;
  p.mask_st = mask_st;
  p.bt_sb = 0;
  p.n_split = n_split;
  p.span_tiles = span_tiles;
  p.scale = scale;
  p.causal = causal;
  p.window = window;
  p.v_in_k = v_in_k;
  return attn_partial::dispatch<false>(p, B, Dk, Dv, q_bf16, kv, row_tile,
                                       static_cast<cudaStream_t>(stream));
}

// Shared memory of the instantiation for head widths (Dk, Dv), these
// dtypes and row tile (for the tests).
extern "C" int fa_smem(int Dk, int Dv, int q_bf16, int kv, int row_tile,
                       int* dynamic, int* static_bytes, int* limit) {
  return attn_partial::smem<false>(Dk, Dv, q_bf16, kv, row_tile, dynamic,
                                   static_bytes, limit);
}
