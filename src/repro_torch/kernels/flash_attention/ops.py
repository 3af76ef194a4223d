"""Flash-attention partials: the Hopper kernel's wrapper, its plain
PyTorch version and the launch counter.

`attend_partial` is the one entry point the model calls. It computes
blocked online-softmax attention and returns the unnormalised partials
(m, l, acc) in the model's layout:

  q      (B, T, Hkv, G, Dk)  GQA group folded into the query
  k, v   (P, S, Hkv, Dk/Dv)  P = B, or a resident slot pool read through
                             `slot_idx` (B,) without a gathered copy
  q_pos  (B, T) int32; k_pos (P, S) int32, -1 = empty slot
  mask   optional (B, T, S) bool, ANDed in (tree masks)
  k_scale, v_scale  (P, S, Hkv) f32, with int8 k, v: one symmetric
         scale per (row, head) (`kv_dtype="int8"` caches)
  -> m, l (B, T, Hkv, G) f32; acc (B, T, Hkv, G, Dv) f32

Dk == Dv is a GQA head (16, 32, 64, 120 or 128 wide), read by one of two
forms chosen from R = T * G, the query rows of one (request, KV head),
the head width and the K/V dtype alone (`tiling`; a masked read, a
tree's fresh segment, stays on the first): the GQA form
(`partial_kernel`: 16 rows a block, f32 FMAs on CUDA cores), where
decode and the other few-row reads win, and from `R_MMA` rows the
many-row form (`rows_kernel`: 64 rows a block share each 32-key tile,
both products on tensor cores; D 64, 120 and 128, f32 or bf16 K/V).
Dk != Dv is the latent form: MLA's absorbed attention, one KV head of
c_kv ++ k_pe (Dk = 576, Dv = 512 at DeepSeek-V3's widths; (40, 32) for
tests) with every query head folded into G. Its kernel shares each
16-key tile over 64 query rows and runs both products on tensor cores;
when `v` is K's first Dv columns (`v_in_k`: MLA passes `k[..., :Dv]`) it
reads V out of K's tile. Every form's tiles come from one place
(`tiling`): the plain version, `plan_splits` and `split_ranges` take the
kernel's key tile, so a slot pool and a page pool holding the same keys
stay bitwise equal.

An int8 K/V pair is the reference's dequantized bf16 view,
bf16(f32(k8) * scale) (`dequantize_kv`): the plain version builds that
view and attends over it; the kernel's int8 form (a kernel of its own,
every GQA head width, D 120's rows staged by 8-byte copies and its bf16
view padded with zero columns to 128) reads the int8 rows and scales in
place, converts each staged tile once to the same bf16 in shared memory
for all the rows that read it, and takes 16 or 64 query rows a block by
R (`tiling`).

Rows are token-major (row r = t * G + g), which is the (B, Hkv, R, D)
contract of the JAX package's Pallas kernel
(`repro/kernels/common.py::flash_attention_partial`) seen through
strides; `flash_attention_partial` below is that contract, for tests.

On a CUDA tensor the wrapper launches the kernel of
`csrc/flash_attention.cu` or raises; on a CPU tensor it runs the plain
version, a transcription of the reference's `attend_partial` arithmetic.
`plan_splits` fixes, from the shapes alone, how many blocks of a cluster
split each (request, KV head, row tile)'s keys and how many key tiles
a block walks at a time; `split_ranges` gives each block's keys, over
which the plain version merged in rank order (`merge_two`) is the
kernel's arithmetic.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels.build import (COUNT_LOCK, CSRC, KernelLibrary,
                                      cuda_stream, refuse_grad)

NEG_INF = -1e30
#: the (Dk, Dv) head widths the kernels are instantiated for: GQA heads
#: (120: h2o-danube3-4b), then the latent form's tiny pair (tests) and
#: DeepSeek-V3's
SUPPORTED_PAIRS = ((16, 16), (32, 32), (64, 64), (120, 120), (128, 128),
                   (40, 32), (576, 512))
#: keys per tile of the kernel; the model's cache reads run the plain
#: version with the same tile on the CPU
KEY_TILE = 32
#: the latent form's key tile and query rows a block: at f32, 64 rows of q
#: (576 values) and two 16-key K tiles fill 226 KB of a block's 227 KB
#: (`attention_partial.cuh::LatentForm`; 32 keys or 128 rows would not fit)
LATENT_KEY_TILE = 16
LATENT_ROW_TILE = 64
_KV_DTYPES = (torch.float32, torch.bfloat16)
_KV_BYTES = {torch.float32: 4, torch.bfloat16: 2}
#: the kernels' K/V storage argument
KV_KIND = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
#: query rows per block of the kernel (GQA form)
ROW_TILE = 16
#: the many-row form (`attention_partial.cuh::RowsForm`): 64 query rows a
#: block, 16 a warp, share each 32-key tile on tensor cores; its head
#: widths
MMA_ROW_TILE = 64
MMA_HEADS = (64, 120, 128)
#: R (query rows of one (request, KV head)) from which unmasked reads of
#: f32 / bf16 K/V at D 64, 120 or 128 go to the many-row form. Measured
#: on the H100 (700 W; tools/kernel_compare.py --phases crossover: both
#: forms at B 4 x Hkv 8 x 630 held keys, R 4-2048): from R 17, where the
#: GQA form needs a second 16-row block, the many-row form took less time
#: at all six (dtype, D) and every R measured (0.54-0.81x at R 17); below
#: it, it took up to 1.48x at five of them and won by at most 6 % at bf16
#: D 120, too little to move decode: one threshold for all. A masked read
#: (a tree's fresh segment: a handful of keys) stays on `partial_kernel`:
#: at f32 the many-row form took 1.14-1.28x its time there (the same
#: tool, --phases kernels,d120)
R_MMA = 17
#: the int8 K/V form's query rows per block: 16 where R <= 16 (each of a
#: block's 8 warps takes every 8th key tile of the same rows), else 64
#: (teams of 4 warps, 16 rows each, share each key tile's bf16 view)
#: (`attention_partial.cuh::Int8Form`)
INT8_ROW_TILES = (16, 64)
#: the int8 form's warps a block and ring of staged int8 key tiles
INT8_WARPS = 8
INT8_STAGES = 8
#: the split plan aims at this many blocks (two per SM of 132), and never
#: splits a (request, head, row tile) over more blocks than this (the
#: non-portable cluster limit of the H100)
SPLIT_TARGET_BLOCKS = 256
MAX_SPLIT = 16
#: the int8 form's target: far fewer blocks. One of its 8-warp blocks
#: fills an SM's registers, so blocks past one a SM run in waves, and
#: every split adds a cluster merge; 64 was the fastest of the targets
#: 32 to 1024 tried on the H100 at phase K's shapes
INT8_SPLIT_TARGET_BLOCKS = 64
#: the latent form's cluster limit: the portable 8 (one of its blocks
#: fills an SM's shared memory)
LATENT_MAX_SPLIT = 8
#: the pool capacity the span is sized for (the serving phases' max_len)
SPLIT_REF_KEYS = 1024

#: kernel launches made by `attend_partial` (a plain integer; reset it
#: to 0 before a run whose launches should be counted)
LAUNCHES = 0
#: the launches of them that read int8 K/V (the int8 form)
LAUNCHES_INT8_KV = 0
#: the launches of them in the latent form (Dk != Dv: MLA)
LAUNCHES_LATENT = 0
#: the launches of them without the causal mask (cross-attention reads,
#: the encoder's bidirectional self-attention)
LAUNCHES_NONCAUSAL = 0
#: the launches of them in the many-row form (unmasked f32 / bf16 K/V,
#: R >= R_MMA)
LAUNCHES_MANY_ROWS = 0
#: the launches of them by head widths (Dk, Dv) (clear it before a run
#: whose launches should be counted)
LAUNCHES_BY_PAIR = {}


def _declare(lib):
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    fn = lib.fa_partial_launch
    fn.argtypes = ([vp] * 12            # q k v q_pos k_pos mask slot
                                        # k_scale v_scale acc m l
                   + [i32] * 7          # B T G H S Dk Dv
                   + [i64] * 20         # strides
                   + [ctypes.c_float]   # scale
                   + [i32] * 8          # causal window q_bf16 kv
                                        # n_split span_tiles v_in_k
                                        # row_tile
                   + [vp])              # stream
    fn.restype = ctypes.c_int
    declare_smem(lib.fa_smem)


def declare_smem(fn):
    """Types of a library's shared-memory report: (Dk, Dv, q_bf16, kv (a
    `KV_KIND` value), row tile (`tiling`'s: 16 or 64 picks the GQA or
    the many-row form of f32 / bf16 K/V), *dynamic, *static, *limit) ->
    CUDA error."""
    ip = ctypes.POINTER(ctypes.c_int)
    fn.argtypes = [ctypes.c_int] * 5 + [ip] * 3
    fn.restype = ctypes.c_int


#: the kernel's source and built library (`csrc/flash_attention.cu`)
LIBRARY = KernelLibrary(
    "flash_attention",
    Path(__file__).resolve().parent / "csrc" / "flash_attention.cu",
    headers=[CSRC / "attention_partial.cuh", CSRC / "smem_report.cuh"],
    declare=_declare)


# =====================================================================
# plain version
# =====================================================================

def dequantize_kv(x8, scale):
    """The reference's dequantized view of an int8 K or V (..., H, D)
    with its (..., H) scales: bf16(f32(x8) * scale)."""
    return (x8.float() * scale[..., None]).to(torch.bfloat16)


def _valid(q_pos, k_pos, causal, window, mask):
    """(B, T, S) keys a query row sees: `attend_partial_plain`'s masks."""
    valid = (k_pos[:, None, :] >= 0).expand(q_pos.shape[0], q_pos.shape[1],
                                            k_pos.shape[1])
    if causal:
        valid = valid & (k_pos[:, None, :] <= q_pos[:, :, None])
    if window:
        valid = valid & (q_pos[:, :, None] - k_pos[:, None, :] < window)
    if mask is not None:
        valid = valid & mask
    return valid


def attend_partial_plain(q, k, v, q_pos, k_pos, *, scale, causal=True,
                         window=0, mask=None, slot_idx=None, block=None,
                         k_scale=None, v_scale=None):
    """Plain PyTorch partials, same arguments and results as
    `attend_partial`: the reference's `attend_partial` (a scan over KV
    blocks) written out with einsum; int8 K/V (with `k_scale`,
    `v_scale`) through their dequantized view (`dequantize_kv`).

    `block` is the number of keys per tile (None: one tile of all S
    keys). The last tile is padded with empty keys to the full width, so
    every tile has the same shape and a tile that no row can see is an
    exact no-op (p = 0, correction exp(0) = 1): two key layouts that hold
    the same keys in the same columns, such as a slot pool and a page
    pool's gathered view of another length, give bitwise equal partials
    for every row."""
    if slot_idx is not None:
        idx = slot_idx.long()
        k, v, k_pos = k[idx], v[idx], k_pos[idx]
        if k_scale is not None:
            k_scale, v_scale = k_scale[idx], v_scale[idx]
    if k_scale is not None:
        k, v = dequantize_kv(k, k_scale), dequantize_kv(v, v_scale)
    B, T, Hkv, G, Dk = q.shape
    S = k.shape[1]
    Dv = v.shape[-1]
    qf = q.float()
    block = max(1, S if block is None else block)
    pad = -S % block
    if pad:
        k = torch.cat([k, k.new_zeros((B, pad) + k.shape[2:])], dim=1)
        v = torch.cat([v, v.new_zeros((B, pad) + v.shape[2:])], dim=1)
        k_pos = torch.cat([k_pos, k_pos.new_full((B, pad), -1)], dim=1)
        if mask is not None:
            mask = torch.cat([mask, mask.new_zeros((B, T, pad))], dim=2)
        S += pad
    m = torch.full((B, T, Hkv, G), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, T, Hkv, G), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, T, Hkv, G, Dv), dtype=torch.float32,
                      device=q.device)
    for s0 in range(0, S, block):
        kc = k[:, s0: s0 + block].float()
        vc = v[:, s0: s0 + block].float()
        s = torch.einsum("bthgd,bshd->bthgs", qf, kc) * scale
        valid = _valid(q_pos, k_pos[:, s0: s0 + block], causal, window,
                       None if mask is None else mask[:, :, s0: s0 + block])
        vb = valid[:, :, None, None, :]
        s = torch.where(vb, s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        # zero fully-masked rows (exp(NEG_INF - NEG_INF) = 1 otherwise)
        p = torch.where(vb, p, torch.zeros_like(p))
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bthgs,bshd->bthgd",
                                                   p, vc)
        m = m_new
    return m, l, acc


# =====================================================================
# split planning (plain Python, tested on the CPU)
# =====================================================================

def many_rows(D: int, kv_bytes: int, R: int) -> bool:
    """Whether f32 (`kv_bytes` 4) or bf16 (2) K/V of head width D over R
    query rows a (request, KV head) take the many-row form (`R_MMA`)."""
    return kv_bytes in (2, 4) and D in MMA_HEADS and R >= R_MMA


def tiling(latent: bool, int8: bool = False, R: int = 1, D: int = 0,
           kv_bytes: int = 0):
    """(keys per tile, most blocks a cluster splits keys over, query rows
    per block) of the form: `latent` for Dk != Dv
    (`attention_partial.cuh::LatentForm`), `int8` for int8 K/V over R
    query rows a (request, KV head) (`Int8Form`: its row tile from R),
    else for f32 / bf16 K/V (`kv_bytes` 4 / 2) of head width D the
    many-row form (`RowsForm`, 64 rows) from `R_MMA` rows, or the GQA
    form (`Form`, 16 rows; also where D and kv_bytes are not given). The
    form depends on these alone, never on the live lengths or a pool's
    capacity."""
    if latent:
        return LATENT_KEY_TILE, LATENT_MAX_SPLIT, LATENT_ROW_TILE
    if int8:
        return KEY_TILE, MAX_SPLIT, INT8_ROW_TILES[R > INT8_ROW_TILES[0]]
    if many_rows(D, kv_bytes, R):
        return KEY_TILE, MAX_SPLIT, MMA_ROW_TILE
    return KEY_TILE, MAX_SPLIT, ROW_TILE


def key_tile(Dk: int, Dv: int) -> int:
    """The kernel's key tile for heads (Dk, Dv): the plain version's tile
    for cache reads."""
    return tiling(Dk != Dv)[0]


@functools.lru_cache(maxsize=1024)
def plan_splits(B: int, H: int, R: int, S: int, latent: bool = False,
                int8: bool = False, D: int = 0, kv_bytes: int = 0):
    """(n_split, span_tiles) for B requests x H KV heads x R query rows
    over S logical keys (`latent`: the Dk != Dv form's tiling; `int8`:
    the int8 K/V form's, whose target is INT8_SPLIT_TARGET_BLOCKS; D and
    `kv_bytes`: f32 / bf16 K/V's form by R, `tiling`). The
    span (key tiles a block walks in one go) comes from the grid alone:
    the fewest power-of-two blocks per (request, head, row tile), at most
    the cluster limit, that give SPLIT_TARGET_BLOCKS blocks over a pool of
    SPLIT_REF_KEYS keys. The cluster then covers S with ceil(tiles / span)
    blocks rounded up to a power of two, at most the limit; past it a
    block walks every n_split-th span. So the plan never reads the live
    lengths, and two capacities holding the same keys (a slot pool, a
    page pool's view) sum the same spans in the same order."""
    kt, max_split, rows = tiling(latent, int8, R, D, kv_bytes)
    target = INT8_SPLIT_TARGET_BLOCKS if int8 else SPLIT_TARGET_BLOCKS
    base = B * H * -(-R // rows)
    n0 = 1
    while n0 < max_split and base * n0 < target:
        n0 *= 2
    span = max(1, SPLIT_REF_KEYS // kt // n0)
    spans = -(-max(1, -(-S // kt)) // span)
    n = 1
    while n < min(spans, max_split):
        n *= 2
    return n, span


def _latent_pitch(d: int, size: int, skew: int = 16) -> int:
    """Elements of a staged latent row of d values of `size` bytes, padded
    to `skew` bytes past a multiple of 128 (`attention_partial.cuh::
    latent_pitch`: bank-conflict-free fragment loads)."""
    return d + (skew - d * size) % 128 // size


def kernel_smem(Dk: int, Dv: int, kv_element_size: int,
                q_element_size: int = 4, many: bool = False) -> int:
    """Dynamic shared memory of one block. GQA form (Dk == Dv): the
    double-buffered K/V tiles in their stored dtype (4 or 2 bytes a
    value), reused for the merge's (ROW_TILE, Dv) f32 rows. The many-row
    form (`many`): the double-buffered 32-key K and V tiles, rows padded
    to 16 bytes past a multiple of 128 (bf16 D 120 rows first to 128
    values), at least the merge's (64, D) f32 rows with m and l and each
    row's fold factors. int8 K/V (1
    byte a value): a ring of INT8_STAGES int8 K/V tiles and a bf16 view
    of one K/V tile for each of up to INT8_WARPS teams (D padded to whole
    16-value steps, rows by 16 bytes), at least the warps' partials
    handed over and the merge's (64,
    D) f32 rows with m and l and each row's fold factors. Latent form: the
    block's 64 rows of q in their dtype (`q_element_size`), two 16-key
    tile buffers (K and K, or K and V), the two partial score tiles; at
    least the merge's
    (LATENT_ROW_TILE, Dv) f32 rows and each row's fold factors, two f32 a
    rank (`LatentSmem`). (Static shared memory is known only from the
    compiled kernel: the `gpu` tests hold this against the kernels'
    request and the sum of both against the device's limit.)"""
    kt, max_split, rows = tiling(Dk != Dv)
    if Dk != Dv:
        # bf16 K/V: rows padded to whole 16-value steps, f32 q read in pairs
        bf16 = kv_element_size == 2
        dk = -(-Dk // 16) * 16 if bf16 else Dk
        skew = 32 if bf16 and q_element_size == 4 else 16
        staged = (rows * _latent_pitch(dk, q_element_size, skew)
                  * q_element_size
                  + 2 * kt * _latent_pitch(dk, kv_element_size)
                  * kv_element_size + 2 * rows * kt * 4)
        return max(staged, rows * Dv * 4 + rows * max_split * 8)
    def merge(rows):
        return (rows * Dv + 2 * rows + rows * max_split * 2) * 4
    if kv_element_size == 1:
        staged = (INT8_STAGES * 2 * kt * Dk
                  + INT8_WARPS * 2 * kt * (2 * (-(-Dk // 16) * 16) + 16))
        handed = (INT8_WARPS - 1) * (Dk // 2 + 4) * 32 * 4
        return max(staged, handed, merge(INT8_ROW_TILES[-1]))
    if many:
        ds = -(-Dk // 16) * 16 if kv_element_size == 2 else Dk
        return max(4 * kt * _latent_pitch(ds, kv_element_size)
                   * kv_element_size, merge(MMA_ROW_TILE))
    return 2 * kt * (Dk + Dv) * kv_element_size


def split_ranges(S: int, n_split: int, span_tiles: int,
                 latent: bool = False):
    """The logical keys each block of a cluster walks, in rank order: a
    list of [lo, hi) ranges per block (spans rank, rank + n_split, ...;
    empty for a block past the last key)."""
    span = span_tiles * tiling(latent)[0]
    return [[(lo, min(S, lo + span))
             for lo in range(r * span, S, n_split * span)]
            for r in range(n_split)]


# =====================================================================
# kernel wrapper
# =====================================================================

def as_int32(t):
    """`t` as a contiguous int32 tensor, without a copy when it is one."""
    if t.dtype != torch.int32 or not t.is_contiguous():
        t = t.to(torch.int32).contiguous()
    return t


def v_in_k(k, v) -> bool:
    """Whether `v` is K's first Dv columns: the same storage, base
    pointer, dtype and leading shape and strides, a contiguous last
    dimension and Dv <= Dk (MLA passes `k[..., :Dv]`). The latent kernel
    then reads V out of K's tile and copies no V tile."""
    return (v.dtype == k.dtype and v.device == k.device
            and v.dim() == k.dim() and v.shape[:-1] == k.shape[:-1]
            and v.shape[-1] <= k.shape[-1]
            and v.stride()[:-1] == k.stride()[:-1]
            and v.stride(-1) == k.stride(-1) == 1
            and v.data_ptr() == k.data_ptr()
            and v.untyped_storage().data_ptr()
            == k.untyped_storage().data_ptr())


def rows_aligned(t) -> bool:
    """The latent kernel copies q rows in 16-byte pieces: the base and the
    strides of every dimension but the last must be 16-byte multiples."""
    per = 16 // t.element_size()
    return t.data_ptr() % 16 == 0 and all(s % per == 0
                                          for s in t.stride()[:-1])


def kv_align(t) -> int:
    """Bytes a K/V row's base and strides must be a multiple of: rows are
    copied in 16-byte pieces, but an int8 row whose width is not a
    multiple of 16 (D 120: 120 bytes) in 8-byte pieces."""
    return 8 if t.element_size() == 1 and t.shape[-1] % 16 else 16


def kv_aligned(t, strides) -> bool:
    """The base and the strides (pool row, key, head) of K or V are
    multiples of `kv_align` bytes."""
    a = kv_align(t)
    per = a // t.element_size()
    return (t.data_ptr() % a == 0 and strides[0] % per == 0
            and strides[1] % per == 0 and strides[2] % per == 0)


def check_pair(check, Dk, Dv, kv_dtype):
    """The head widths a kernel is instantiated for (`SUPPORTED_PAIRS`);
    the latent form (Dk != Dv) reads f32 or bf16 K/V only."""
    check((Dk, Dv) in SUPPORTED_PAIRS, lambda: (
        f"head widths (Dk, Dv) = ({Dk}, {Dv}); supported pairs "
        f"{SUPPORTED_PAIRS}"))
    check(Dk == Dv or kv_dtype in _KV_DTYPES, lambda: (
        f"the latent form (Dk != Dv) reads float32 / bfloat16 K/V, got "
        f"{kv_dtype}"))


def launch_plan(B, Hkv, T, G, S, Dk, Dv, kv_dtype, masked=False):
    """(n_split, span_tiles, row tile, many-row form) of a launch over B
    requests x Hkv KV heads x T tokens x G heads a group and S logical
    keys (a page pool's view: n_view x page_size), `masked` with a bool
    mask (kernel 1's tree segments, which stay on the GQA form): one
    function of these for both wrappers, so the paged kernel is kernel 1
    on the gathered view."""
    latent, int8 = Dk != Dv, kv_dtype == torch.int8
    size = 0 if latent or masked else _KV_BYTES.get(kv_dtype, 0)
    n_split, span = plan_splits(B, Hkv, T * G, S, latent, int8, Dk, size)
    rows = tiling(latent, int8, T * G, Dk, size)[2]
    return n_split, span, rows, rows == MMA_ROW_TILE and not (latent or
                                                              int8)


def check_kv(check, k, v, k_scale, v_scale, lead, Hkv, dev):
    """The K/V storage a kernel takes: f32 or bf16 K and V alike, or
    int8 K and V with f32 scales of shape `lead` + (Hkv,) on `dev`.
    Returns the kernels' `kv` argument and the scales' six strides (zeros
    without scales)."""
    check(k.dtype == v.dtype and k.dtype in KV_KIND, lambda: (
        f"dtypes k={k.dtype} v={v.dtype}; supported float32 / bfloat16 / "
        "int8, k and v alike"))
    int8 = k.dtype == torch.int8
    check(int8 == (k_scale is not None) == (v_scale is not None), lambda: (
        "int8 k and v need k_scale and v_scale, and only int8 k and v "
        "take them"))
    if not int8:
        return KV_KIND[k.dtype], (0,) * 6
    shape = tuple(lead) + (Hkv,)
    for name, t in (("k_scale", k_scale), ("v_scale", v_scale)):
        check(t.dtype == torch.float32 and tuple(t.shape) == shape
              and t.device == dev, lambda: (
                  f"{name} must be float32 {shape} on {dev}, got "
                  f"{t.dtype} {tuple(t.shape)} on {t.device}"))
    return KV_KIND[torch.int8], tuple(k_scale.stride()) + tuple(
        v_scale.stride())


def empty_partials(shape, Dv, dev):
    """(m, l, acc) outputs as contiguous views of one allocation."""
    n = 1
    for d in shape:
        n *= d
    buf = torch.empty(n * (Dv + 2), dtype=torch.float32, device=dev)
    return (buf[:n].view(shape), buf[n: 2 * n].view(shape),
            buf[2 * n:].view(*shape, Dv))


def _check(cond, msg):
    """Raise on a failed check; `msg` is a string or a callable that
    builds it."""
    if not cond:
        raise ValueError(f"flash-attention kernel: "
                         f"{msg() if callable(msg) else msg}")


_FN = None


def _launch(q, k, v, q_pos, k_pos, *, scale, causal, window, mask,
            slot_idx, k_scale=None, v_scale=None):
    B, T, Hkv, G, Dk = q.shape
    P, S = k.shape[0], k.shape[1]
    Dv = v.shape[-1]
    dev = q.device
    refuse_grad("flash-attention kernel", "its output has none here: "
                "self-contained attention takes `attention` (a gradient "
                "through the kernel's forward), a cache read has no "
                "gradient", q, k, v, k_scale, v_scale)
    # (messages are built only when a check fails: this runs per call)
    check_pair(_check, Dk, Dv, k.dtype)
    _check(q.dtype in _KV_DTYPES, lambda: (
        f"dtype q={q.dtype}; supported float32 / bfloat16"))
    _check(k.shape == (P, S, Hkv, Dk) and v.shape == (P, S, Hkv, Dv),
           "k/v shapes")
    kv, sc = check_kv(_check, k, v, k_scale, v_scale, (P, S), Hkv, dev)
    qs, ks, vs = q.stride(), k.stride(), v.stride()
    _check(qs[4] == 1 and ks[3] == 1 and vs[3] == 1,
           "q, k and v need a contiguous last (head) dimension")
    _check(kv_aligned(k, ks) and kv_aligned(v, vs), "k and v need 16-byte "
           "aligned rows, base and strides (int8 rows of D 120: 8-byte)")
    for name, t in (("k", k), ("v", v), ("q_pos", q_pos), ("k_pos", k_pos),
                    ("mask", mask), ("slot_idx", slot_idx)):
        _check(t is None or t.device == dev, lambda: (
            f"{name} is on {t.device}, q on {dev}"))
    _check(q_pos.shape == (B, T) and k_pos.shape == (P, S),
           "q_pos (B, T) / k_pos (P, S) shapes")
    q_pos = as_int32(q_pos)
    k_pos = as_int32(k_pos)
    if slot_idx is None:
        _check(P == B, lambda: f"k/v batch {P} != q batch {B} without "
               "slot_idx")
    else:
        _check(slot_idx.shape == (B,), "slot_idx must be (B,)")
        slot_idx = as_int32(slot_idx)
    if mask is not None:
        _check(mask.shape == (B, T, S) and mask.dtype == torch.bool,
               "mask must be a (B, T, S) bool tensor")
        if not mask.is_contiguous():
            mask = mask.contiguous()

    m, l, acc = empty_partials((B, T, Hkv, G), Dv, dev)
    if B * T * G == 0:
        return m.fill_(NEG_INF), l.zero_(), acc.zero_()
    if Dk != Dv and not rows_aligned(q):
        q = q.clone(memory_format=torch.contiguous_format)
        qs = q.stride()

    global _FN, LAUNCHES, LAUNCHES_INT8_KV, LAUNCHES_LATENT
    global LAUNCHES_NONCAUSAL, LAUNCHES_MANY_ROWS
    if _FN is None:
        _FN = LIBRARY.load().fa_partial_launch
    int8 = kv == KV_KIND[torch.int8]
    n_split, span, rows, many = launch_plan(B, Hkv, T, G, S, Dk, Dv,
                                            k.dtype, mask is not None)
    rc = _FN(q.data_ptr(), k.data_ptr(), v.data_ptr(), q_pos.data_ptr(),
             k_pos.data_ptr(), 0 if mask is None else mask.data_ptr(),
             0 if slot_idx is None else slot_idx.data_ptr(),
             0 if k_scale is None else k_scale.data_ptr(),
             0 if v_scale is None else v_scale.data_ptr(),
             acc.data_ptr(), m.data_ptr(), l.data_ptr(),
             B, T, G, Hkv, S, Dk, Dv,
             qs[0], qs[1], qs[2], qs[3], ks[0], ks[1], ks[2],
             vs[0], vs[1], vs[2], *sc, k_pos.stride(0), q_pos.stride(0),
             0 if mask is None else mask.stride(0),
             0 if mask is None else mask.stride(1),
             float(scale), int(bool(causal)), int(window),
             int(q.dtype == torch.bfloat16), kv, n_split, span,
             int(v_in_k(k, v)), rows, cuda_stream(dev))
    if rc != 0:
        raise RuntimeError(f"flash-attention kernel launch failed: CUDA "
                           f"error {rc}")
    with COUNT_LOCK:
        LAUNCHES += 1
        if int8:
            LAUNCHES_INT8_KV += 1
        if Dk != Dv:
            LAUNCHES_LATENT += 1
        if not causal:
            LAUNCHES_NONCAUSAL += 1
        if many:
            LAUNCHES_MANY_ROWS += 1
        LAUNCHES_BY_PAIR[Dk, Dv] = LAUNCHES_BY_PAIR.get((Dk, Dv), 0) + 1
    return m, l, acc


def attend_partial(q, k, v, q_pos, k_pos, *, scale, causal=True, window=0,
                   mask=None, slot_idx=None, block=None, k_scale=None,
                   v_scale=None):
    """Online-softmax partials (m, l, acc); see the module docstring.

    CUDA tensors launch the Hopper kernel (or raise on what it does not
    take: an int8 pair is read in place by its int8 form, never
    dequantized here); CPU tensors run `attend_partial_plain`. `block` is
    the plain version's KV block (the kernel tiles keys itself)."""
    if q.device.type == "cuda":
        return _launch(q, k, v, q_pos, k_pos, scale=scale, causal=causal,
                       window=window, mask=mask, slot_idx=slot_idx,
                       k_scale=k_scale, v_scale=v_scale)
    if q.device.type != "cpu":
        raise ValueError(f"flash-attention: unsupported device {q.device}")
    return attend_partial_plain(q, k, v, q_pos, k_pos, scale=scale,
                                causal=causal, window=window, mask=mask,
                                slot_idx=slot_idx, block=block,
                                k_scale=k_scale, v_scale=v_scale)


# =====================================================================
# the gradient of self-contained attention
# =====================================================================

#: keys a tile of the gradient's walk: its intermediates are
#: (B, T, Hkv, G, GRAD_KEY_TILE) f32, never (B, T, Hkv, G, S)
GRAD_KEY_TILE = 256


def attention_grad(q, k, v, q_pos, k_pos, out, lse, d_out, *, scale,
                   causal=True, window=0, mask=None):
    """(dq, dk, dv) of normalised attention out = softmax(q k^T scale) v
    under the masks of `attend_partial` (q (B, T, Hkv, G, Dk), k / v
    (B, S, Hkv, Dk / Dv), P = B), given the forward's f32 output `out`
    and its row log-sum-exp `lse` (B, T, Hkv, G) (0 for a fully masked
    row). Walks the keys in tiles: p = exp(s - lse) recomputed under the
    masks, dV = p^T dO, D = rowsum(dO * O), dS = p (dO V^T - D),
    dQ = scale dS K, dK = scale dS^T Q; dK and dV summed over a KV head's
    G query heads. In f32, each gradient cast to its input's dtype."""
    B, T, Hkv, G, Dk = q.shape
    S, Dv = k.shape[1], v.shape[-1]
    qf, do = q.float(), d_out.float()
    delta = (do * out).sum(-1)[..., None]                  # (B,T,Hkv,G,1)
    lse = lse[..., None]
    dq = torch.zeros_like(qf)
    dk = torch.empty((B, S, Hkv, Dk), dtype=torch.float32, device=q.device)
    dv = torch.empty((B, S, Hkv, Dv), dtype=torch.float32, device=q.device)
    tile = GRAD_KEY_TILE
    for s0 in range(0, S, tile):
        kc = k[:, s0: s0 + tile].float()
        vc = v[:, s0: s0 + tile].float()
        valid = _valid(q_pos, k_pos[:, s0: s0 + tile], causal, window,
                       None if mask is None else mask[:, :, s0: s0 + tile])
        s = torch.einsum("bthgd,bshd->bthgs", qf, kc) * scale
        # masked scores at NEG_INF: p = 0 there, and in a fully masked
        # row (lse 0) everywhere, so its gradients are 0, never NaN
        s = torch.where(valid[:, :, None, None, :], s,
                        torch.full_like(s, NEG_INF))
        p = torch.exp(s - lse)
        dv[:, s0: s0 + tile] = torch.einsum("bthgs,bthgd->bshd", p, do)
        ds = p * (torch.einsum("bthgd,bshd->bthgs", do, vc) - delta)
        dq += torch.einsum("bthgs,bshd->bthgd", ds, kc) * scale
        dk[:, s0: s0 + tile] = torch.einsum("bthgs,bthgd->bshd", ds,
                                            qf) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class AttentionFunction(torch.autograd.Function):
    """Self-contained attention (P = B: no slot_idx, no int8 scales) with
    a gradient. The forward is `attend_partial` normalised as `finalize`
    (on CUDA the hand-written kernel, on the CPU the plain version), the
    backward `attention_grad`: tensor ops, the counterpart of the
    reference's autodiff (no TPU kernel had a backward). The row
    log-sum-exp comes from the kernel's own partials: m is the natural-log
    running max of the scaled scores, so lse = m + log(l)."""

    @staticmethod
    def forward(ctx, q, k, v, q_pos, k_pos, scale, causal, window, mask,
                block):
        m, l, acc = attend_partial(q, k, v, q_pos, k_pos, scale=scale,
                                   causal=causal, window=window, mask=mask,
                                   block=block)
        out = finalize((m, l, acc))
        lse = torch.where(l > 0, m + torch.log(l), torch.zeros_like(m))
        ctx.save_for_backward(q, k, v, q_pos, k_pos, mask, out, lse)
        ctx.args = (scale, causal, window)
        return out.to(q.dtype)

    @staticmethod
    def backward(ctx, d_out):
        q, k, v, q_pos, k_pos, mask, out, lse = ctx.saved_tensors
        scale, causal, window = ctx.args
        dq, dk, dv = attention_grad(q, k, v, q_pos, k_pos, out, lse, d_out,
                                    scale=scale, causal=causal,
                                    window=window, mask=mask)
        return dq, dk, dv, None, None, None, None, None, None, None


def attention(q, k, v, q_pos, k_pos, *, scale, causal=True, window=0,
              mask=None, block=None):
    """Normalised self-contained attention in q's dtype, differentiable
    in q, k and v (`AttentionFunction`); the arguments are
    `attend_partial`'s without slot_idx and scales. A `v` that is a view
    of `k` (MLA's `k[..., :Dv]`) passes its gradient on to K."""
    return AttentionFunction.apply(q, k, v, q_pos, k_pos, scale, causal,
                                   window, mask, block)


# =====================================================================
# merge, and the Pallas kernel's (B, Hkv, R, D) contract
# =====================================================================

def merge_two(a, b):
    """Exactly merge two (m, l, acc) partial states."""
    m_a, l_a, acc_a = a
    m_b, l_b, acc_b = b
    m = torch.maximum(m_a, m_b)
    ea = torch.exp(m_a - m)
    eb = torch.exp(m_b - m)
    return m, l_a * ea + l_b * eb, acc_a * ea[..., None] + acc_b * eb[..., None]


def finalize(partial):
    """Normalise (m, l, acc); a fully masked row (l = 0) gives 0."""
    _m, l, acc = partial
    l = torch.where(l == 0.0, torch.ones_like(l), l)
    return acc / l[..., None]


def flash_attention_partial(q, k, v, q_pos, k_pos, *, scale, causal=True,
                            window=0, mask=None):
    """The Pallas kernel's contract: q (B, Hkv, R, Dk); k (B, Hkv, S, Dk);
    v (B, Hkv, S, Dv); q_pos (B, R); k_pos (B, S); mask (B, R, S) bool.
    Returns acc (B, Hkv, R, Dv), m (B, Hkv, R), l (B, Hkv, R), all f32."""
    qm = q.permute(0, 2, 1, 3).unsqueeze(3)          # (B, R, Hkv, 1, Dk)
    m, l, acc = attend_partial(
        qm, k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3), q_pos, k_pos,
        scale=scale, causal=causal, window=window, mask=mask,
        block=max(8, min(128, k.shape[2])))
    return (acc[:, :, :, 0].permute(0, 2, 1, 3), m[..., 0].permute(0, 2, 1),
            l[..., 0].permute(0, 2, 1))


def merge_partials(parts):
    """Merge [(acc, m, l), ...] in the kernel layout; normalised output."""
    acc, m, l = parts[0]
    state = (m, l, acc)
    for acc2, m2, l2 in parts[1:]:
        state = merge_two(state, (m2, l2, acc2))
    return finalize(state)
