// Mamba2 SSD scan for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `ssd_scan_pallas` of the JAX package
// (src/repro/kernels/ssd_scan/kernel.py, body `_make_ssd_kernel`). For
// one request b and head h (group g = h / (H / G) of B and C):
//
//   state_t = exp(dt_t A_h) state_{t-1} + dt_t x_t B_tᵀ      (P x N, f32)
//   y_t     = state_t C_t
//
// x (b, L, H, P) and B, C (b, L, G, N), all f32 or all bf16, are read
// through element strides (unit stride along P and N, 16-byte aligned
// rows), so the mixer's views of its conv output need no copy, and B, C
// are read per group in place (no head broadcast). dt (b, L, H) and A (H,)
// are f32. y (b, L, H, P) is written in x's dtype.
//
// The state is read from and written to a (rows, H, P, N) f32 tensor IN
// PLACE: request b's rows are slot_idx[b] (b without slot_idx). The
// initial state may be null (zeros) and the output null (no state
// written: verification). Input and output may be the same tensor: each
// block reads the rows it owns before it writes them, and no two real
// requests share a slot (padding rows on a scratch slot race among
// themselves only; their outputs are undefined).
//
// Row p of the state and column p of y depend only on column p of x, so
// the grid is (P / Pb, H, b): each block owns Pb rows of one head's state
// and needs no reduction across blocks. Each block recomputes what a
// chunk's rows share (the cumulative dt A, the decays, the scores).
//
// Two paths, picked by `ssd_scan/ops.py::plan` from the shapes alone:
//
// * The recurrence (decode, verification, short extends). Each thread
//   holds REC_CPT (8) consecutive columns of one state row in registers, read
//   once and written once with 16-byte accesses; per token
//     s = exp(dt A) s + (dt x_p) B,   y_p = sum_n C_n s_{p,n}
//   with the sum over a row's lanes by warp shuffles. Tokens are staged
//   in shared memory REC_TOKENS at a time. What bounds it: the bytes of
//   the state (decode) or the f32 operations (5 P N a token).
//
// * The chunk path (prefill, long extends): the dual form over chunks of
//   Q tokens (cum_i = sum_{k <= i} dt_k A_h):
//     y_i   = sum_{j <= i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j
//             + exp(cum_i) C_i state_in
//     state = exp(cum_{Q-1}) state_in
//             + sum_j exp(cum_{Q-1} - cum_j) dt_j x_j B_jᵀ
//   Its four products (C Bᵀ, M X, C Sᵀ and the state update) run on
//   tensor cores, `mma.sync.m16n8k8` TF32 with f32 accumulation, each f32
//   operand split into a TF32 high part and a TF32 residual and each
//   product taken as hi·hi + hi·lo + lo·hi (3×TF32, to about 2^-19);
//   a bf16 operand is exact in TF32, so its residual product is skipped.
//   The next chunk's x, B, C and dt are staged with `cp.async` while the
//   current one computes (two stages). The state slice stays in shared
//   memory from the first chunk to the last. A block has 16 warps where
//   the plan gives each SM one block, 8 where it gives two. What bounds
//   it: its bound is the f32 operations or the bytes, but the kernel runs
//   far above both (PERF.md §6): every P-slice re-reads the chunk's B and
//   C from L2 and recomputes its scores, and each warp's products form
//   short dependent chains.
//
// Details both paths keep:
//   * The decay exp(cum_i - cum_j) is computed only for i >= j: above
//     the diagonal the exponent is positive and may overflow, and inf x 0
//     would be NaN.
//   * dt = 0 tokens (masked by the caller, or past L in the last chunk,
//     which load as zeros) decay the state by exp(0) = 1 and add exactly
//     nothing.
//   * N is a power of two from 8 to 256; the chunk path pads N = 8 to the
//     16-row tile with zero columns.
//
// The C entry point launches on the caller's stream, allocates nothing,
// and returns the first CUDA error (0 on success); `ssd_smem` reports a
// path's shared memory.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

#include "../../csrc/smem_report.cuh"

namespace {

constexpr int REC_THREADS = 256;              // most threads of a block
constexpr int REC_TOKENS = 16;                // tokens staged at a time
constexpr int REC_CPT = 8;                    // state columns a thread

struct Args {
  const void* x;
  const float* dt;
  const float* A;
  const void* B;
  const void* C;
  const float* state_in;    // (rows, H, P, N) or null (zeros)
  float* state_out;         // (rows, H, P, N) or null (not written)
  const int* slot_idx;      // (b,) rows of the state, or null (row b)
  int rows;                 // the state's rows (a slot outside traps)
  void* y;
  int b, L, H, P, G, N;
  int Q, Pb;                // chunk length (chunk path), rows per block
  int64_t sxb, sxl, sxh;    // x strides (b, l, h); unit along P
  int64_t sdb, sdl, sdh;    // dt strides
  int64_t sbb, sbl, sbg;    // B strides (b, l, g); unit along N
  int64_t scb, scl, scg;    // C strides
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}
__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// first state row (p = 0) of request bi, head h, in rows of N floats; a
// slot outside the state stops the kernel with an error, as an index
// outside a gather would
__device__ __forceinline__ int64_t state_row(const Args& a, int bi, int h) {
  const int64_t r = a.slot_idx != nullptr ? a.slot_idx[bi] : bi;
  if (r < 0 || r >= a.rows) __trap();
  return (r * a.H + h) * a.P;
}

// ------------------------------------------------------------ recurrence

template <typename XT>
__global__ void __launch_bounds__(REC_THREADS) ssd_rec_kernel(Args a) {
  constexpr int CPT = REC_CPT;
  extern __shared__ __align__(16) float rsm[];
  const int N = a.N, Pb = a.Pb, TPR = N / CPT;
  float* Bs = rsm;                        // REC_TOKENS x N
  float* Cs = Bs + REC_TOKENS * N;        // REC_TOKENS x N
  float* Xs = Cs + REC_TOKENS * N;        // REC_TOKENS x Pb
  float* dts = Xs + REC_TOKENS * Pb;      // REC_TOKENS

  const int p0 = blockIdx.x * Pb, h = blockIdx.y, bi = blockIdx.z;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int row = tid / TPR, n0 = (tid - row * TPR) * CPT;
  const unsigned mask = nthreads >= 32 ? 0xffffffffu
                                       : (1u << nthreads) - 1u;
  const int grp = h / (a.H / a.G);
  const float Ah = a.A[h];
  const XT* xg = static_cast<const XT*>(a.x) + bi * a.sxb + h * a.sxh + p0;
  const XT* bg = static_cast<const XT*>(a.B) + bi * a.sbb + grp * a.sbg;
  const XT* cg = static_cast<const XT*>(a.C) + bi * a.scb + grp * a.scg;
  const float* dtg = a.dt + bi * a.sdb + h * a.sdh;
  XT* yg = static_cast<XT*>(a.y) +
           (static_cast<int64_t>(bi) * a.L * a.H + h) * a.P + p0 + row;
  const int64_t sy = static_cast<int64_t>(a.H) * a.P;
  const int64_t soff = (state_row(a, bi, h) + p0 + row) * N + n0;

  float s[CPT];
#pragma unroll
  for (int k = 0; k < CPT; k += 4) {
    const float4 v = a.state_in != nullptr
        ? *reinterpret_cast<const float4*>(a.state_in + soff + k)
        : make_float4(0.f, 0.f, 0.f, 0.f);
    s[k] = v.x; s[k + 1] = v.y; s[k + 2] = v.z; s[k + 3] = v.w;
  }

  for (int t0 = 0; t0 < a.L; t0 += REC_TOKENS) {
    const int nt = min(REC_TOKENS, a.L - t0);
    __syncthreads();                       // the last tokens are read
    for (int e = tid; e < nt * N; e += nthreads) {
      const int j = e / N, n = e - j * N;
      Bs[e] = to_f32(bg[(t0 + j) * a.sbl + n]);
      Cs[e] = to_f32(cg[(t0 + j) * a.scl + n]);
    }
    for (int e = tid; e < nt * Pb; e += nthreads) {
      const int j = e / Pb, p = e - j * Pb;
      Xs[e] = to_f32(xg[(t0 + j) * a.sxl + p]);
    }
    for (int j = tid; j < nt; j += nthreads) dts[j] = dtg[(t0 + j) * a.sdl];
    __syncthreads();
    for (int j = 0; j < nt; ++j) {
      const float dtj = dts[j];
      const float da = expf(dtj * Ah), u = dtj * Xs[j * Pb + row];
      float part = 0.f;
#pragma unroll
      for (int k = 0; k < CPT; k += 4) {
        const float4 bv =
            *reinterpret_cast<const float4*>(Bs + j * N + n0 + k);
        const float4 cv =
            *reinterpret_cast<const float4*>(Cs + j * N + n0 + k);
        s[k] = fmaf(u, bv.x, da * s[k]);
        s[k + 1] = fmaf(u, bv.y, da * s[k + 1]);
        s[k + 2] = fmaf(u, bv.z, da * s[k + 2]);
        s[k + 3] = fmaf(u, bv.w, da * s[k + 3]);
        part = fmaf(cv.x, s[k], part);
        part = fmaf(cv.y, s[k + 1], part);
        part = fmaf(cv.z, s[k + 2], part);
        part = fmaf(cv.w, s[k + 3], part);
      }
      for (int o = TPR / 2; o > 0; o >>= 1)
        part += __shfl_xor_sync(mask, part, o);
      if (n0 == 0) store1(yg + (t0 + j) * sy, part);
    }
  }

  if (a.state_out != nullptr) {
#pragma unroll
    for (int k = 0; k < CPT; k += 4)
      *reinterpret_cast<float4*>(a.state_out + soff + k) =
          make_float4(s[k], s[k + 1], s[k + 2], s[k + 3]);
  }
}

// ------------------------------------------------------------ chunk path

__host__ __device__ inline int align16(int v) { return (v + 15) & ~15; }

// Byte offsets of the chunk path's dynamic shared memory. Row pitches are
// padded so that every mma fragment load and store of a warp falls on
// distinct banks (or on words two lanes share), and every row starts on
// 16 bytes for cp.async.
struct ChunkSmem {
  int npad, np, xp, mp, ns;
  int b_off, c_off, x_off, dt_off, stage;   // stage 0; stage s adds s * stage
  int ms_off, st_off, yi_off, cum_off, wend_off, eexp_off, bytes;

  __host__ __device__ ChunkSmem(int Q, int N, int Pb, int esize) {
    npad = N < 16 ? 16 : N;               // state rows: whole 16-row tiles
    np = npad + (esize == 4 ? 4 : 8);     // B, C tiles (Q x np, x's type)
    xp = Pb % 16 == 8 ? Pb : Pb + 8;      // x tile (Q x xp, x's type)
    mp = Q + 4;                           // scores (Q x mp, f32)
    ns = npad + 4;                        // state slice (Pb x ns, f32)
                                          // inter-chunk y: Q x xp, f32
    b_off = 0;
    c_off = b_off + align16(Q * np * esize);
    x_off = c_off + align16(Q * np * esize);
    dt_off = x_off + align16(Q * xp * esize);
    stage = dt_off + align16(Q * 4);
    ms_off = 2 * stage;
    st_off = ms_off + align16(Q * mp * 4);
    yi_off = st_off + align16(Pb * ns * 4);
    cum_off = yi_off + align16(Q * xp * 4);
    wend_off = cum_off + align16(Q * 4);
    eexp_off = wend_off + align16(Q * 4);
    bytes = eexp_off + align16(Q * 4);
  }
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(gmem), "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// v = hi + lo in TF32: hi is v with the 13 low mantissa bits cleared, lo
// the exact residual v - hi cleared the same way (|lo| < 2^-10 |v|, so
// hi + lo carries 21 bits of v's 24: products good to about 2^-19). Bit
// masks, not `cvt.rna.tf32`: the conversion unit's rate would bound every
// product. An EXACT value (a bf16 input) is its own high part.
constexpr uint32_t TF32_MASK = 0xffffe000u;
template <bool EXACT>
__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  if (EXACT) {
    hi = __float_as_uint(v);
    lo = 0u;
  } else {
    hi = __float_as_uint(v) & TF32_MASK;
    lo = __float_as_uint(v - __uint_as_float(hi)) & TF32_MASK;
  }
}
__device__ __forceinline__ void mma(float* d, const uint32_t* a,
                                    const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
// d += a b as three independent sums (hi·hi into d[0], lo·hi into d[1],
// hi·lo into d[2]: three short dependency chains, added at the end by
// `total`); an exact operand's residual product is skipped
template <bool AEX, bool BEX>
__device__ __forceinline__ void mma3(float (&d)[3][4], const uint32_t* ah,
                                     const uint32_t* al, const uint32_t* bh,
                                     const uint32_t* bl) {
  if (!AEX) mma(d[1], al, bh);
  if (!BEX) mma(d[2], ah, bl);
  mma(d[0], ah, bh);
}
__device__ __forceinline__ float total(const float (&d)[3][4], int q) {
  return d[0][q] + (d[1][q] + d[2][q]);
}

// Fragments of m16n8k8 (g = lane / 4, t = lane % 4): A (16 x 8, row i, k):
// a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4); B (8 x 8, k,
// col n): b0 (t, g), b1 (t + 4, g); D (16 x 8): d0 (g, 2t), d1 (g, 2t + 1),
// d2 (g + 8, 2t), d3 (g + 8, 2t + 1).
// A from a row-major tile: p points at (row g, col t), pitch in elements.
template <bool EX, typename T>
__device__ __forceinline__ void frag_a(const T* p, int pitch, uint32_t* hi,
                                       uint32_t* lo) {
  split<EX>(to_f32(p[0]), hi[0], lo[0]);
  split<EX>(to_f32(p[8 * pitch]), hi[1], lo[1]);
  split<EX>(to_f32(p[4]), hi[2], lo[2]);
  split<EX>(to_f32(p[8 * pitch + 4]), hi[3], lo[3]);
}
// B whose k runs along memory: p points at (k t, col g); element (k, n)
// at p[k - t + (n - g) * pitch]
template <bool EX, typename T>
__device__ __forceinline__ void frag_b_kfast(const T* p, uint32_t* hi,
                                             uint32_t* lo) {
  split<EX>(to_f32(p[0]), hi[0], lo[0]);
  split<EX>(to_f32(p[4]), hi[1], lo[1]);
}
// B whose columns run along memory: p points at (k t, col g), pitch the
// k step
template <bool EX, typename T>
__device__ __forceinline__ void frag_b_nfast(const T* p, int pitch,
                                             uint32_t* hi, uint32_t* lo) {
  split<EX>(to_f32(p[0]), hi[0], lo[0]);
  split<EX>(to_f32(p[4 * pitch]), hi[1], lo[1]);
}

// Stage chunk t0's B, C (Q x N), x (Q x Pb) and dt (Q) into stage s;
// tokens past L load as zeros.
template <typename XT, int THREADS>
__device__ __forceinline__ void load_chunk(const Args& a, const ChunkSmem& S,
                                           char* smem, int s, int t0,
                                           const XT* xg, const XT* bg,
                                           const XT* cg, const float* dtg) {
  constexpr int V = 16 / sizeof(XT);      // elements a 16-byte copy moves
  char* base = smem + s * S.stage;
  XT* Bs = reinterpret_cast<XT*>(base + S.b_off);
  XT* Cs = reinterpret_cast<XT*>(base + S.c_off);
  XT* Xs = reinterpret_cast<XT*>(base + S.x_off);
  float* dts = reinterpret_cast<float*>(base + S.dt_off);
  const int nv = min(a.Q, a.L - t0);
  const int pr = a.N / V, xr = a.Pb / V;
  for (int e = threadIdx.x; e < a.Q * pr; e += THREADS) {
    const int j = e / pr, k = (e - j * pr) * V;
    const bool ok = j < nv;
    const int64_t tj = ok ? t0 + j : 0;
    cp_async16(Bs + j * S.np + k, bg + tj * a.sbl + k, ok);
    cp_async16(Cs + j * S.np + k, cg + tj * a.scl + k, ok);
  }
  for (int e = threadIdx.x; e < a.Q * xr; e += THREADS) {
    const int j = e / xr, k = (e - j * xr) * V;
    const bool ok = j < nv;
    cp_async16(Xs + j * S.xp + k, xg + (ok ? t0 + j : 0) * a.sxl + k, ok);
  }
  for (int j = threadIdx.x; j < a.Q; j += THREADS) {
    const bool ok = j < nv;
    cp_async4(dts + j, dtg + (ok ? t0 + j : 0) * a.sdl, ok);
  }
}

// THREADS is 256 (two blocks an SM) or 512 (one block an SM); either way
// a thread may hold 128 registers.
template <typename XT, int THREADS>
__global__ void __launch_bounds__(THREADS, 512 / THREADS)
    ssd_chunk_kernel(Args a) {
  constexpr int WARPS = THREADS / 32;
  extern __shared__ __align__(16) char smem[];
  constexpr bool EX = std::is_same<XT, __nv_bfloat16>::value;
  const ChunkSmem S(a.Q, a.N, a.Pb, sizeof(XT));
  const int Q = a.Q, N = a.N, NPAD = S.npad, Pb = a.Pb;
  const int p0 = blockIdx.x * Pb, h = blockIdx.y, bi = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int grp = h / (a.H / a.G);
  const float Ah = a.A[h];
  const XT* xg = static_cast<const XT*>(a.x) + bi * a.sxb + h * a.sxh + p0;
  const XT* bg = static_cast<const XT*>(a.B) + bi * a.sbb + grp * a.sbg;
  const XT* cg = static_cast<const XT*>(a.C) + bi * a.scb + grp * a.scg;
  const float* dtg = a.dt + bi * a.sdb + h * a.sdh;
  XT* yg = static_cast<XT*>(a.y) +
           (static_cast<int64_t>(bi) * a.L * a.H + h) * a.P + p0;
  const int64_t sy = static_cast<int64_t>(a.H) * a.P;
  float* Ms = reinterpret_cast<float*>(smem + S.ms_off);
  float* St = reinterpret_cast<float*>(smem + S.st_off);
  float* cum = reinterpret_cast<float*>(smem + S.cum_off);
  float* wend = reinterpret_cast<float*>(smem + S.wend_off);
  float* eexp = reinterpret_cast<float*>(smem + S.eexp_off);

  // the state slice in (zero columns past N), and B, C's padding columns
  const int64_t srow = state_row(a, bi, h) + p0;
  for (int e = tid; e < Pb * NPAD; e += THREADS) {
    const int p = e / NPAD, n = e - p * NPAD;
    St[p * S.ns + n] = a.state_in != nullptr && n < N
                           ? a.state_in[(srow + p) * N + n] : 0.f;
  }
  if (NPAD > N) {
    for (int s = 0; s < 2; ++s)
      for (int e = tid; e < Q * (NPAD - N); e += THREADS) {
        const int j = e / (NPAD - N), n = N + e - j * (NPAD - N);
        char* base = smem + s * S.stage;
        reinterpret_cast<XT*>(base + S.b_off)[j * S.np + n] = from_f32<XT>(0.f);
        reinterpret_cast<XT*>(base + S.c_off)[j * S.np + n] = from_f32<XT>(0.f);
      }
  }

  load_chunk<XT, THREADS>(a, S, smem, 0, 0, xg, bg, cg, dtg);
  cp_async_commit();
  const int nchunks = (a.L + Q - 1) / Q;
  const int R = Q / 16, PT = Pb / 8;
  for (int c = 0; c < nchunks; ++c) {
    const int s = c & 1, t0 = c * Q, nv = min(Q, a.L - t0);
    if (c + 1 < nchunks)
      load_chunk<XT, THREADS>(a, S, smem, s ^ 1, t0 + Q, xg, bg, cg, dtg);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const char* base = smem + s * S.stage;
    const XT* Bs = reinterpret_cast<const XT*>(base + S.b_off);
    const XT* Cs = reinterpret_cast<const XT*>(base + S.c_off);
    const XT* Xs = reinterpret_cast<const XT*>(base + S.x_off);
    const float* dts = reinterpret_cast<const float*>(base + S.dt_off);

    // (a) cumulative dt A by a warp scan (Q <= 64: two tokens a lane),
    // and the decays every later step reads
    if (warp == 0) {
      float v0 = lane < Q ? dts[lane] * Ah : 0.f;
      float v1 = lane + 32 < Q ? dts[lane + 32] * Ah : 0.f;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float u0 = __shfl_up_sync(0xffffffffu, v0, o);
        const float u1 = __shfl_up_sync(0xffffffffu, v1, o);
        if (lane >= o) {
          v0 += u0;
          v1 += u1;
        }
      }
      v1 += __shfl_sync(0xffffffffu, v0, 31);
      const float last =
          __shfl_sync(0xffffffffu, Q > 32 ? v1 : v0, (Q - 1) & 31);
      if (lane < Q) {
        cum[lane] = v0;
        wend[lane] = expf(last - v0) * dts[lane];
        eexp[lane] = expf(v0);
      }
      if (lane + 32 < Q) {
        cum[lane + 32] = v1;
        wend[lane + 32] = expf(last - v1) * dts[lane + 32];
        eexp[lane + 32] = expf(v1);
      }
    }
    __syncthreads();

    // (b) the products with C's rows as A, 16 x 8 tiles: for each 16-row
    // strip r, its scores tiles on or below the diagonal,
    //   M[i][j] = (C_i . B_j) exp(cum_i - cum_j) dt_j  (j <= i),
    // and its inter-chunk tiles Yi[i][p] = exp(cum_i) C_i . S_p (S the
    // state before this chunk); 2r + 2 + PT tiles a strip
    float* Yi = reinterpret_cast<float*>(smem + S.yi_off);
    for (int k = warp; k < R * (R + 1) + R * PT; k += WARPS) {
      int r = 0, u = k;
      while (u >= 2 * r + 2 + PT) {
        u -= 2 * r + 2 + PT;
        ++r;
      }
      float d[3][4] = {};
      const XT* pa = Cs + (16 * r + g) * S.np + t;
      if (u < 2 * r + 2) {
        const XT* pb = Bs + (8 * u + g) * S.np + t;
        for (int kk = 0; kk < NPAD; kk += 8) {
          uint32_t ah[4], al[4], bh[2], bl[2];
          frag_a<EX>(pa + kk, S.np, ah, al);
          frag_b_kfast<EX>(pb + kk, bh, bl);
          mma3<EX, EX>(d, ah, al, bh, bl);
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int i = 16 * r + g + 8 * (q >> 1), j = 8 * u + 2 * t + (q & 1);
          Ms[i * S.mp + j] =
              j <= i ? total(d, q) * expf(cum[i] - cum[j]) * dts[j] : 0.f;
        }
      } else {
        const int cc = u - (2 * r + 2);
        const float* ps = St + (8 * cc + g) * S.ns + t;
        for (int kk = 0; kk < NPAD; kk += 8) {
          uint32_t ah[4], al[4], bh[2], bl[2];
          frag_a<EX>(pa + kk, S.np, ah, al);
          frag_b_kfast<false>(ps + kk, bh, bl);
          mma3<EX, false>(d, ah, al, bh, bl);
        }
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int i = 16 * r + g + 8 * hh;
          const float e = eexp[i];
          *reinterpret_cast<float2*>(Yi + i * S.xp + 8 * cc + 2 * t) =
              make_float2(e * total(d, 2 * hh), e * total(d, 2 * hh + 1));
        }
      }
    }
    __syncthreads();

    // (c) y = M X + Yi, 16 tokens x 8 columns a tile, and (d) the state
    // as Sᵀ (rows n, columns p): exp(cum_last) S + (w B)ᵀ X with
    // w_j = exp(cum_last - cum_j) dt_j, 16 x 8 tiles. (c) reads Ms, Yi
    // and x, (d) writes only the state, which (b) has finished reading.
    const float dec = expf(cum[Q - 1]);
    for (int k = warp; k < R * PT + (NPAD / 16) * PT; k += WARPS) {
      if (k < R * PT) {
        const int r = k / PT, cc = k - r * PT;
        float d[3][4] = {};
        const float* pm = Ms + (16 * r + g) * S.mp + t;
        const XT* px = Xs + t * S.xp + 8 * cc + g;
        for (int kk = 0; kk < 16 * r + 16; kk += 8) {
          uint32_t ah[4], al[4], bh[2], bl[2];
          frag_a<false>(pm + kk, S.mp, ah, al);
          frag_b_nfast<EX>(px + kk * S.xp, S.xp, bh, bl);
          mma3<false, EX>(d, ah, al, bh, bl);
        }
        const int pcol = 8 * cc + 2 * t;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int i = 16 * r + g + 8 * hh;
          if (i < nv) {
            const float2 e =
                *reinterpret_cast<const float2*>(Yi + i * S.xp + pcol);
            store2(yg + (t0 + i) * sy + pcol, total(d, 2 * hh) + e.x,
                   total(d, 2 * hh + 1) + e.y);
          }
        }
      } else {
        const int kt = k - R * PT;
        const int r = kt / PT, cc = kt - r * PT;
        const int n0 = 16 * r + g, pc = 8 * cc + 2 * t;
        float* s00 = St + pc * S.ns + n0;
        float d[3][4] = {{dec * s00[0], dec * s00[S.ns], dec * s00[8],
                          dec * s00[S.ns + 8]}};
        const XT* pbt = Bs + t * S.np + n0;       // (n, j) = Bs[j][n]
        const XT* px = Xs + t * S.xp + 8 * cc + g;
        for (int kk = 0; kk < Q; kk += 8) {
          uint32_t ah[4], al[4], bh[2], bl[2];
          const float w0 = wend[kk + t], w1 = wend[kk + t + 4];
          split<false>(w0 * to_f32(pbt[kk * S.np]), ah[0], al[0]);
          split<false>(w0 * to_f32(pbt[kk * S.np + 8]), ah[1], al[1]);
          split<false>(w1 * to_f32(pbt[(kk + 4) * S.np]), ah[2], al[2]);
          split<false>(w1 * to_f32(pbt[(kk + 4) * S.np + 8]), ah[3], al[3]);
          frag_b_nfast<EX>(px + kk * S.xp, S.xp, bh, bl);
          mma3<false, EX>(d, ah, al, bh, bl);
        }
        s00[0] = total(d, 0);
        s00[S.ns] = total(d, 1);
        s00[8] = total(d, 2);
        s00[S.ns + 8] = total(d, 3);
      }
    }
    __syncthreads();
  }

  if (a.state_out != nullptr) {
    for (int e = tid; e < Pb * N; e += THREADS) {
      const int p = e / N, n = e - p * N;
      a.state_out[(srow + p) * N + n] = St[p * S.ns + n];
    }
  }
}

// ------------------------------------------------------------ launchers

int rec_smem_bytes(int N, int Pb) {
  return REC_TOKENS * (2 * N + Pb + 1) * 4;
}

template <typename K>
int allow_smem(K kernel, int smem, int& allowed) {
  if (smem > allowed) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    allowed = smem;
  }
  return 0;
}

template <typename XT, int THREADS>
int launch_chunk(const Args& a, cudaStream_t stream) {
  static int allowed = 48 * 1024;         // the default without opt-in
  const int smem = ChunkSmem(a.Q, a.N, a.Pb, sizeof(XT)).bytes;
  const int e = allow_smem(ssd_chunk_kernel<XT, THREADS>, smem, allowed);
  if (e != 0) return e;
  ssd_chunk_kernel<XT, THREADS><<<dim3(a.P / a.Pb, a.H, a.b), THREADS, smem,
                                  stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename XT>
int launch_rec(const Args& a, cudaStream_t stream) {
  static int allowed = 48 * 1024;
  const int smem = rec_smem_bytes(a.N, a.Pb);
  const int e = allow_smem(ssd_rec_kernel<XT>, smem, allowed);
  if (e != 0) return e;
  ssd_rec_kernel<XT><<<dim3(a.P / a.Pb, a.H, a.b), a.Pb * (a.N / REC_CPT),
                       smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The recurrence's plan must give each thread REC_CPT columns of its Pb
// rows of N columns.
template <typename XT>
int launch(const Args& a, int chunk_path, int threads, cudaStream_t stream) {
  if (chunk_path)
    return threads == 512 ? launch_chunk<XT, 512>(a, stream)
                          : launch_chunk<XT, 256>(a, stream);
  if (a.Pb * a.N != threads * REC_CPT)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_rec<XT>(a, stream);
}

template <typename XT>
int report(int chunk_path, int threads, int Q, int N, int Pb, int* dynamic,
           int* static_bytes, int* limit) {
  const int chunk_smem = ChunkSmem(Q, N, Pb, sizeof(XT)).bytes;
  if (chunk_path)
    return threads == 512
        ? smem_report(ssd_chunk_kernel<XT, 512>, chunk_smem, dynamic,
                      static_bytes, limit)
        : smem_report(ssd_chunk_kernel<XT, 256>, chunk_smem, dynamic,
                      static_bytes, limit);
  if (Pb * N != threads * REC_CPT)
    return static_cast<int>(cudaErrorInvalidValue);
  return smem_report(ssd_rec_kernel<XT>, rec_smem_bytes(N, Pb), dynamic,
                     static_bytes, limit);
}

}  // namespace

extern "C" int ssd_scan_launch(
    const void* x, const void* dt, const void* A, const void* B,
    const void* C, const void* state_in, void* state_out,
    const void* slot_idx, void* y, int rows,
    int b, int L, int H, int P, int G, int N,
    int chunk_path, int Q, int Pb, int threads,
    int64_t sxb, int64_t sxl, int64_t sxh,
    int64_t sdb, int64_t sdl, int64_t sdh,
    int64_t sbb, int64_t sbl, int64_t sbg,
    int64_t scb, int64_t scl, int64_t scg,
    int bf16, void* stream) {
  Args a;
  a.x = x;
  a.dt = static_cast<const float*>(dt);
  a.A = static_cast<const float*>(A);
  a.B = B;
  a.C = C;
  a.state_in = static_cast<const float*>(state_in);
  a.state_out = static_cast<float*>(state_out);
  a.slot_idx = static_cast<const int*>(slot_idx);
  a.rows = rows;
  a.y = y;
  a.b = b; a.L = L; a.H = H; a.P = P; a.G = G; a.N = N;
  a.Q = Q; a.Pb = Pb;
  a.sxb = sxb; a.sxl = sxl; a.sxh = sxh;
  a.sdb = sdb; a.sdl = sdl; a.sdh = sdh;
  a.sbb = sbb; a.sbl = sbl; a.sbg = sbg;
  a.scb = scb; a.scl = scl; a.scg = scg;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (chunk_path ? threads != 256 && threads != 512
                 : threads <= 0 || threads > REC_THREADS)
    return static_cast<int>(cudaErrorInvalidValue);
  return bf16 ? launch<__nv_bfloat16>(a, chunk_path, threads, s)
              : launch<float>(a, chunk_path, threads, s);
}

// The dynamic shared memory a path's launch asks for, the compiled
// kernel's static size and the device's limit per block.
extern "C" int ssd_smem(int chunk_path, int threads, int Q, int N, int Pb,
                        int bf16, int* dynamic, int* static_bytes,
                        int* limit) {
  return bf16 ? report<__nv_bfloat16>(chunk_path, threads, Q, N, Pb,
                                      dynamic, static_bytes, limit)
              : report<float>(chunk_path, threads, Q, N, Pb, dynamic,
                              static_bytes, limit);
}
