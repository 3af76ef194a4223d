// Attention partials over a paged KV pool, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `paged_flash_decode` of the JAX package
// (src/repro/kernels/decode_attention/kernel.py, body
// `_make_paged_kernel`): flash attention over a physical page pool
// k/v (P, ps, Hkv, D) with positions page_pos (P, ps) (-1 = empty), where
// request b reads its logical pages through its row of the (B, n_view)
// int32 block table. The Pallas kernel walks the table as a
// scalar-prefetch grid axis and serves one decode token (G query rows);
// this kernel serves that decode form and the multi-row causal form
// (R = T * G rows, one position per token) that verification's cache
// pass, commit and prefill make on the pool, so no pool read goes through
// a gathered copy. Unmapped view entries point at the NULL page, whose
// positions stay -1: its tiles are skipped, an exact no-op.
//
// What bounds it on the H100: as the resident kernel, the K/V bytes of
// the pages a request holds, read once per 16 query rows, over the
// 3.35 TB/s of HBM (decode and verification), and for reads of many rows
// a KV head (R >= `ops.py::R_MMA`: prefill chunks, commits) the products,
// which the many-row form (`rows_kernel`) runs on tensor cores, 64 rows
// sharing each key tile.
//
// What the design does about it: the block table is read inside the
// kernel, one entry per key of a key tile (three tiles ahead of its
// use), and K/V rows are copied from their physical page in place by
// 16-byte `cp.async` once their offsets are known, so HBM carries only
// the pages held (the reference's XLA path gathers the view into a
// resident copy first, which reads and writes every byte once more). The
// kernel body is `../../csrc/attention_partial.cuh`, shared with the
// resident kernel: the logical keys are split over a cluster and walked
// in the same key tiles, split the same way, with the same tile
// skipping and merge order, so the partials are bit for bit those of
// `flash_attention.cu` on the gathered view, for f32, bf16 and int8 pools
// alike, in either form of f32 / bf16 pools (both wrappers choose it from
// the same (R, D, dtype): `ops.py::launch_plan`) (an int8 pool's kernel,
// `int8_kernel`, reads each key's page,
// scales and position through the block table and copies its K and V
// rows from the page), and for MLA's latent pools (Dk = 576, Dv = 512) as well, whose kernel
// (`latent_kernel`) bulk-copies each key row from its page and reads V
// out of K's tile when the pool's `v` is K's first 512 columns.
// Element offsets are computed in int64.
//
// The C entry point launches on the caller's stream, allocates nothing
// and returns cudaGetLastError().

#include "../../csrc/attention_partial.cuh"

extern "C" int paged_partial_launch(
    const void* q, const void* k, const void* v, const void* q_pos,
    const void* page_pos, const void* block_table, const void* k_scale,
    const void* v_scale, void* acc, void* m,
    void* l, int B, int T, int G, int H, int n_view, int page_size, int Dk,
    int Dv,
    int64_t q_sb, int64_t q_st, int64_t q_sh, int64_t q_sg, int64_t k_sp,
    int64_t k_ss, int64_t k_sh, int64_t v_sp, int64_t v_ss, int64_t v_sh,
    int64_t ksc_sp, int64_t ksc_ss, int64_t ksc_sh, int64_t vsc_sp,
    int64_t vsc_ss, int64_t vsc_sh, int64_t pos_sp, int64_t qpos_sb,
    int64_t bt_sb, float scale, int window, int q_bf16, int kv, int n_split,
    int span_tiles, int v_in_k, int row_tile, void* stream) {
  attn_partial::Params p{};
  p.q = q;
  p.k = k;
  p.v = v;
  p.q_pos = static_cast<const int32_t*>(q_pos);
  p.k_pos = static_cast<const int32_t*>(page_pos);
  p.mask = nullptr;
  p.slot_idx = nullptr;
  p.block_table = static_cast<const int32_t*>(block_table);
  p.k_scale = static_cast<const float*>(k_scale);
  p.v_scale = static_cast<const float*>(v_scale);
  p.acc = static_cast<float*>(acc);
  p.m = static_cast<float*>(m);
  p.l = static_cast<float*>(l);
  p.T = T;
  p.G = G;
  p.H = H;
  p.S = n_view * page_size;
  p.page_size = page_size;
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
  p.kpos_sp = pos_sp;
  p.qpos_sb = qpos_sb;
  p.mask_sb = 0;
  p.mask_st = 0;
  p.bt_sb = bt_sb;
  p.n_split = n_split;
  p.span_tiles = span_tiles;
  p.scale = scale;
  p.causal = 1;
  p.window = window;
  p.v_in_k = v_in_k;
  return attn_partial::dispatch<true>(p, B, Dk, Dv, q_bf16, kv, row_tile,
                                      static_cast<cudaStream_t>(stream));
}

// Shared memory of the instantiation for head widths (Dk, Dv), these
// dtypes and row tile (for the tests).
extern "C" int paged_smem(int Dk, int Dv, int q_bf16, int kv, int row_tile,
                          int* dynamic, int* static_bytes, int* limit) {
  return attn_partial::smem<true>(Dk, Dv, q_bf16, kv, row_tile, dynamic,
                                  static_bytes, limit);
}
