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
  -> m, l (B, T, Hkv, G) f32; acc (B, T, Hkv, G, Dv) f32

Rows are token-major (row r = t * G + g), which is the (B, Hkv, R, D)
contract of the JAX package's Pallas kernel
(`repro/kernels/common.py::flash_attention_partial`) seen through
strides; `flash_attention_partial` below is that contract, for tests.

On a CUDA tensor the wrapper launches the kernel of
`csrc/flash_attention.cu` or raises; on a CPU tensor it runs the plain
version, a transcription of the reference's `attend_partial` arithmetic.
`plan_splits` fixes, from the shapes alone, how many blocks of a cluster
split each (request, KV head, 16-row tile)'s keys and how many key tiles
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
                                      cuda_stream)

NEG_INF = -1e30
SUPPORTED_HEAD_DIMS = (16, 32, 64, 128)
#: keys per tile of the kernel; the model's cache reads run the plain
#: version with the same tile on the CPU
KEY_TILE = 32
_KV_DTYPES = (torch.float32, torch.bfloat16)
#: query rows per block of the kernel
ROW_TILE = 16
#: the split plan aims at this many blocks (two per SM of 132), and never
#: splits a (request, head, row tile) over more blocks than this (the
#: non-portable cluster limit of the H100)
SPLIT_TARGET_BLOCKS = 256
MAX_SPLIT = 16
#: the pool capacity the span is sized for (the serving phases' max_len)
SPLIT_REF_KEYS = 1024

#: kernel launches made by `attend_partial` (a plain integer; reset it
#: to 0 before a run whose launches should be counted)
LAUNCHES = 0


def _declare(lib):
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    fn = lib.fa_partial_launch
    fn.argtypes = ([vp] * 10            # q k v q_pos k_pos mask slot acc m l
                   + [i32] * 6          # B T G H S D
                   + [i64] * 14         # strides
                   + [ctypes.c_float]   # scale
                   + [i32] * 6          # causal window q_bf16 kv_bf16
                                        # n_split span_tiles
                   + [vp])              # stream
    fn.restype = ctypes.c_int
    declare_smem(lib.fa_smem)


def declare_smem(fn):
    """Types of a library's shared-memory report: (D, q_bf16, kv_bf16,
    *dynamic, *static, *limit) -> CUDA error."""
    ip = ctypes.POINTER(ctypes.c_int)
    fn.argtypes = [ctypes.c_int] * 3 + [ip] * 3
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

def attend_partial_plain(q, k, v, q_pos, k_pos, *, scale, causal=True,
                         window=0, mask=None, slot_idx=None, block=None):
    """Plain PyTorch partials, same arguments and results as
    `attend_partial`: the reference's `attend_partial` (a scan over KV
    blocks) written out with einsum.

    `block` is the number of keys per tile (None: one tile of all S
    keys). The last tile is padded with empty keys to the full width, so
    every tile has the same shape and a tile that no row can see is an
    exact no-op (p = 0, correction exp(0) = 1): two key layouts that hold
    the same keys in the same columns, such as a slot pool and a page
    pool's gathered view of another length, give bitwise equal partials
    for every row."""
    if slot_idx is not None:
        k, v, k_pos = k[slot_idx], v[slot_idx], k_pos[slot_idx]
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
        kpc = k_pos[:, s0: s0 + block]
        s = torch.einsum("bthgd,bshd->bthgs", qf, kc) * scale
        valid = (kpc[:, None, :] >= 0).expand(B, T, kpc.shape[1])
        if causal:
            valid = valid & (kpc[:, None, :] <= q_pos[:, :, None])
        if window:
            valid = valid & (q_pos[:, :, None] - kpc[:, None, :] < window)
        if mask is not None:
            valid = valid & mask[:, :, s0: s0 + block]
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

@functools.lru_cache(maxsize=1024)
def plan_splits(B: int, H: int, R: int, S: int):
    """(n_split, span_tiles) for B requests x H KV heads x R query rows
    over S logical keys. The span (32-key tiles a block walks in one go)
    comes from the grid alone: the fewest power-of-two blocks per
    (request, head, row tile), at most MAX_SPLIT, that give
    SPLIT_TARGET_BLOCKS blocks over a pool of SPLIT_REF_KEYS keys. The
    cluster then covers S with ceil(tiles / span) blocks rounded up to a
    power of two, at most MAX_SPLIT; past MAX_SPLIT spans a block walks
    every n_split-th span. So the plan never reads the live lengths, and
    two capacities holding the same keys (a slot pool, a page pool's
    view) sum the same spans in the same order."""
    base = B * H * -(-R // ROW_TILE)
    n0 = 1
    while n0 < MAX_SPLIT and base * n0 < SPLIT_TARGET_BLOCKS:
        n0 *= 2
    span = max(1, SPLIT_REF_KEYS // KEY_TILE // n0)
    spans = -(-max(1, -(-S // KEY_TILE)) // span)
    n = 1
    while n < min(spans, MAX_SPLIT):
        n *= 2
    return n, span


def kernel_smem(D: int, kv_element_size: int) -> int:
    """Dynamic shared memory of one block: the double-buffered K/V tiles,
    reused for the merge's (ROW_TILE, D) f32 rows. (Static shared memory
    is known only from the compiled kernel: the `gpu` tests hold this
    against the kernels' request and the sum of both against the
    device's limit.)"""
    return 2 * 2 * KEY_TILE * D * kv_element_size


def split_ranges(S: int, n_split: int, span_tiles: int):
    """The logical keys each block of a cluster walks, in rank order: a
    list of [lo, hi) ranges per block (spans rank, rank + n_split, ...;
    empty for a block past the last key)."""
    span = span_tiles * KEY_TILE
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


def kv_aligned(t, strides) -> bool:
    """K/V rows are copied in 16-byte pieces: the base and the strides
    (pool row, key, head) must be 16-byte multiples."""
    per = 16 // t.element_size()
    return (t.data_ptr() % 16 == 0 and strides[0] % per == 0
            and strides[1] % per == 0 and strides[2] % per == 0)


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
            slot_idx):
    B, T, Hkv, G, Dk = q.shape
    P, S = k.shape[0], k.shape[1]
    Dv = v.shape[-1]
    dev = q.device
    # (messages are built only when a check fails: this runs per call)
    _check(Dk == Dv and Dk in SUPPORTED_HEAD_DIMS, lambda: (
        f"head dims Dk={Dk}, Dv={Dv}; supported Dk == Dv in "
        f"{SUPPORTED_HEAD_DIMS}"))
    _check(q.dtype in _KV_DTYPES and k.dtype in _KV_DTYPES
           and v.dtype == k.dtype, lambda: (
               f"dtypes q={q.dtype} k={k.dtype} v={v.dtype}; supported "
               "float32 / bfloat16, k and v alike"))
    _check(k.shape == (P, S, Hkv, Dk) and v.shape == (P, S, Hkv, Dv),
           "k/v shapes")
    qs, ks, vs = q.stride(), k.stride(), v.stride()
    _check(qs[4] == 1 and ks[3] == 1 and vs[3] == 1,
           "q, k and v need a contiguous last (head) dimension")
    _check(kv_aligned(k, ks) and kv_aligned(v, vs), "k and v need 16-byte "
           "aligned rows (base and strides)")
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

    global _FN, LAUNCHES
    if _FN is None:
        _FN = LIBRARY.load().fa_partial_launch
    n_split, span = plan_splits(B, Hkv, T * G, S)
    rc = _FN(q.data_ptr(), k.data_ptr(), v.data_ptr(), q_pos.data_ptr(),
             k_pos.data_ptr(), 0 if mask is None else mask.data_ptr(),
             0 if slot_idx is None else slot_idx.data_ptr(),
             acc.data_ptr(), m.data_ptr(), l.data_ptr(),
             B, T, G, Hkv, S, Dk,
             qs[0], qs[1], qs[2], qs[3], ks[0], ks[1], ks[2],
             vs[0], vs[1], vs[2], k_pos.stride(0), q_pos.stride(0),
             0 if mask is None else mask.stride(0),
             0 if mask is None else mask.stride(1),
             float(scale), int(bool(causal)), int(window),
             int(q.dtype == torch.bfloat16), int(k.dtype == torch.bfloat16),
             n_split, span, cuda_stream(dev))
    if rc != 0:
        raise RuntimeError(f"flash-attention kernel launch failed: CUDA "
                           f"error {rc}")
    with COUNT_LOCK:
        LAUNCHES += 1
    return m, l, acc


def attend_partial(q, k, v, q_pos, k_pos, *, scale, causal=True, window=0,
                   mask=None, slot_idx=None, block=None):
    """Online-softmax partials (m, l, acc); see the module docstring.

    CUDA tensors launch the Hopper kernel (or raise on what it does not
    take); CPU tensors run `attend_partial_plain`. `block` is the plain
    version's KV block (the kernel tiles keys itself)."""
    if q.device.type == "cuda":
        return _launch(q, k, v, q_pos, k_pos, scale=scale, causal=causal,
                       window=window, mask=mask, slot_idx=slot_idx)
    if q.device.type != "cpu":
        raise ValueError(f"flash-attention: unsupported device {q.device}")
    return attend_partial_plain(q, k, v, q_pos, k_pos, scale=scale,
                                causal=causal, window=window, mask=mask,
                                slot_idx=slot_idx, block=block)


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
