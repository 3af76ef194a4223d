"""Fused int8 dequantisation + GEMV: the Hopper kernel's wrapper, its
plain PyTorch version and the launch counter.

`int8_gemv(x, w8, scale)` computes `(x @ w8) * scale` with f32
accumulation: x (..., K) f32 or bf16; w8 a (K, N) int8 tensor or view —
the dense (K, N) weight, or the (V, D) embedding table as its transpose
`w8.t()` (the quantized tied-logits head); scale: N f32 per-output-column
scales of any shape with N elements ((1, N) for dense weights, (V, 1) for
the table). Returns (..., N) in x's dtype; the kernel's output is f32 and
is cast once.

On a CUDA tensor the wrapper launches one kernel of `csrc/int8_gemv.cu`
for any number of rows, or raises; on a CPU tensor it runs
`int8_gemv_plain`. `plan` picks the kernel path from the shapes alone
(no host sync): split-K over a thread-block cluster for few rows of the
dense layout, a streaming pass for the transposed table, tensor cores
(`wgmma`) for bf16 x with many rows. `launch_plan` launches one given
plan; `chip_smoke.py` times the paths against each other through it.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import NamedTuple

import torch

from repro_torch.kernels.build import (COUNT_LOCK, CSRC, KernelLibrary,
                                      cuda_stream)

_X_DTYPES = (torch.float32, torch.bfloat16)

#: bf16 x with at least this many rows runs on tensor cores (wgmma), in
#: either layout; fewer rows (decode) run the CUDA-core paths: split-K for
#: the dense layout, the rows kernel for the transposed head table.
#: Measured by `chip_smoke.py`'s crossover (NVIDIA H100 80GB HBM3, 700 W;
#: PERF.md §6): at 4 rows the CUDA-core paths are within 2 % of wgmma or
#: faster (wg/wu 0.0097 against 0.0126 ms, the head 0.0822 against
#: 0.1183); from 5 rows they run 8-row blocks and wgmma is faster on every
#: product (the head 0.1168 against 0.1432 ms, wg/wu 0.0125 against
#: 0.0197), but for the 128-column wk/wv, where the two stay within 13 %
#: of each other up to 32 rows.
TC_MIN_ROWS = 5
#: the split-K plan aims at this many blocks (132 SMs on the H100)...
SPLITK_TARGET_BLOCKS = 96
#: ... and at most this many rows of K per cluster rank (a thread reads
#: 1/128 of them, 8 rows in flight)
SPLITK_MAX_ROWS = 1536
#: cluster sizes the split-K and wgmma paths may use (16 is non-portable)
CLUSTER_SIZES = (1, 2, 4, 8, 16)
#: column tile of the split-K path: one 16-byte load of a weight row per
#: thread (32 columns were 2.5x slower on wg/wu: PERF.md §6)
SPLITK_TN = 16
#: each cluster rank reads at least this many rows of K
SPLITK_MIN_ROWS = 32
#: rows of x the split-K kernel stages at a time, and its threads
SPLITK_KC, SPLITK_THREADS = 1024, 128
#: the transposed (rows) layout stages a row block of x as f32 in shared
#: memory: rows * round_up(K, 16) * 4 bytes <= this
ROWS_SMEM_MAX = 200 * 1024
#: tensor-core tile: 64 rows x BN columns x 64 k, three ring stages (a
#: fourth cost a block per SM and was slower: PERF.md §6)
TC_BM, TC_BK, TC_STAGES = 64, 64, 3
#: the wgmma plan splits K over a cluster until it has this many blocks,
#: each rank keeping at least TC_MIN_KTILES k-tiles
TC_TARGET_BLOCKS, TC_MIN_KTILES = 192, 2

#: kernel launches made by `int8_gemv` (a plain integer; reset it to 0
#: before a run whose launches should be counted)
LAUNCHES = 0


def _declare(lib):
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.int8_splitk_launch.argtypes = (
        [vp] * 4 + [i32] * 3 + [i64] * 2      # x w8 scale y, M K N, sx sk
        + [i32] * 3 + [vp])                   # mb cs x_bf16, stream
    lib.int8_rows_launch.argtypes = (
        [vp] * 4 + [i32] * 3 + [i64] * 2      # x w8 scale y, M K N, sx sn
        + [i32] * 3 + [vp])                   # mb n_sm x_bf16, stream
    lib.int8_tc_launch.argtypes = (
        [vp] * 4 + [i32] * 3 + [i64] * 2      # x w8 scale y, M K N, sx sw
        + [i32] * 3 + [vp])                   # rows bn cs, stream
    ip = ctypes.POINTER(ctypes.c_int)
    lib.int8_smem.argtypes = [i32] * 4 + [ip] * 3   # path param variant K
    for fn in (lib.int8_splitk_launch, lib.int8_rows_launch,
               lib.int8_tc_launch, lib.int8_smem):
        fn.restype = ctypes.c_int


#: the kernel's source and built library (`csrc/int8_gemv.cu`)
LIBRARY = KernelLibrary(
    "int8_gemv", Path(__file__).resolve().parent / "csrc" / "int8_gemv.cu",
    headers=[CSRC / "smem_report.cuh"], declare=_declare)


def int8_gemv_plain(x, w8, scale):
    """Plain PyTorch version: `(x.float() @ w8.float()) * scale`, f32,
    shaped (..., N)."""
    return (x.float() @ w8.float()) * scale.reshape(-1).float()


# =====================================================================
# path planning (plain Python, tested on the CPU)
# =====================================================================

class Plan(NamedTuple):
    """One launch: `path` is "splitk", "rows" or "tc"; `mb` rows per
    block (splitk, rows); `cs` blocks per cluster splitting K (splitk,
    tc); `sms` the SMs the rows kernel fills (it launches as many blocks
    as fit at once); `bn` columns per block (tc; split-K blocks own
    SPLITK_TN columns)."""
    path: str
    mb: int = 0
    cs: int = 1
    sms: int = 0
    bn: int = 0


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _rows_per_block(M: int) -> int:
    mb = 1
    while mb < min(M, 8):
        mb *= 2
    return mb


def splitk_smem(mb: int) -> int:
    """Dynamic shared memory of the split-K kernel: the staged x chunk."""
    return mb * SPLITK_KC * 4


def rows_smem(mb: int, K: int) -> int:
    """Dynamic shared memory of the rows kernel: x rows as f32."""
    return mb * _cdiv(K, 16) * 16 * 4


def tc_smem(bn: int) -> int:
    """Dynamic shared memory of the tensor-core kernel: the ring of
    (bf16 x tile, int8 w tile) stages and the bf16 w tile."""
    return TC_STAGES * (TC_BM * TC_BK * 2 + TC_BK * bn) + bn * TC_BK * 2


def splitk_ranges(K: int, cs: int):
    """Rows [lo, hi) of K that each cluster rank reads, as the kernel
    cuts them (kslice = ceil(K / cs); trailing ranks may be empty)."""
    ks = _cdiv(K, cs)
    return [(min(K, q * ks), min(K, (q + 1) * ks)) for q in range(cs)]


def _splitk_cluster(K: int, N: int, mblocks: int) -> int:
    """The smallest cluster that gives SPLITK_TARGET_BLOCKS blocks with
    at most SPLITK_MAX_ROWS rows per rank, each rank reading at least
    SPLITK_MIN_ROWS rows; else the largest those limits allow."""
    sizes = [cs for cs in CLUSTER_SIZES
             if cs == 1 or _cdiv(K, cs) >= SPLITK_MIN_ROWS]
    for cs in sizes:
        if (_cdiv(N, SPLITK_TN) * cs * mblocks >= SPLITK_TARGET_BLOCKS
                and _cdiv(K, cs) <= SPLITK_MAX_ROWS):
            return cs
    return sizes[-1]


def tc_plan(M: int, K: int, N: int, n_sm: int) -> Plan:
    """wgmma tiles: 128 columns a block when that still fills the SMs;
    K split over a cluster while the tiles are too few (extend rows, a
    long K), each rank keeping TC_MIN_KTILES k-tiles or more."""
    mt = _cdiv(M, TC_BM)
    bn = 128 if mt * _cdiv(N, 128) >= n_sm else 64
    tiles, nk = mt * _cdiv(N, bn), _cdiv(K, TC_BK)
    cs = 1
    while (cs < CLUSTER_SIZES[-1] and tiles * cs < TC_TARGET_BLOCKS
           and _cdiv(nk, 2 * cs) >= TC_MIN_KTILES):
        cs *= 2
    return Plan("tc", cs=cs, bn=bn)


def tc_ranges(K: int, cs: int):
    """k-tiles [lo, hi) each cluster rank of the wgmma path reads."""
    nk = _cdiv(K, TC_BK)
    per = _cdiv(nk, cs)
    return [(min(nk, q * per), min(nk, (q + 1) * per)) for q in range(cs)]


def splitk_plan(M: int, K: int, N: int) -> Plan:
    """Split-K row blocks and the cluster splitting K."""
    mb = _rows_per_block(M)
    return Plan("splitk", mb=mb, cs=_splitk_cluster(K, N, _cdiv(M, mb)))


def rows_plan(M: int, K: int, n_sm: int) -> Plan:
    """Row blocks of the rows kernel, halved while x's rows overflow
    ROWS_SMEM_MAX."""
    mb = _rows_per_block(M)
    while mb > 1 and rows_smem(mb, K) > ROWS_SMEM_MAX:
        mb //= 2
    return Plan("rows", mb=mb, sms=n_sm)


@functools.lru_cache(maxsize=4096)
def plan(M: int, K: int, N: int, rows_layout: bool, x_bf16: bool,
         n_sm: int = 132) -> Plan:
    """The kernel path and its tiling for x (M, K) @ w8 (K, N), from the
    shapes alone. `rows_layout`: w8 has unit stride along K (the
    transposed table)."""
    if x_bf16 and M >= TC_MIN_ROWS:
        return tc_plan(M, K, N, n_sm)
    if rows_layout:
        return rows_plan(M, K, n_sm)
    return splitk_plan(M, K, N)


def plan_smem(p: Plan, K: int) -> int:
    """Dynamic shared memory the plan's launch asks for. (Static shared
    memory is known only from the compiled kernel: the `gpu` tests hold
    each path's dynamic request against the kernel's, and the sum of both
    against the device's limit.)"""
    if p.path == "tc":
        return tc_smem(p.bn)
    if p.path == "rows":
        return rows_smem(p.mb, K)
    return splitk_smem(p.mb)


# =====================================================================
# kernel wrapper
# =====================================================================

def _check(cond, msg):
    """Raise on a failed check; `msg` is a string or a callable that
    builds it."""
    if not cond:
        raise ValueError(f"int8 GEMV kernel: "
                         f"{msg() if callable(msg) else msg}")


_FNS = None


@functools.lru_cache(maxsize=None)
def _n_sm(index: int) -> int:
    """SMs of CUDA device `index`, cached (two threads' first calls may
    both ask the device; they get the same count)."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def launch_plan(x2, w8, scale, p: Plan):
    """Launch plan `p` on x2 (M, K) with unit stride along K, w8 and a
    contiguous scale; returns y (M, N) f32. Any path that serves w8's
    layout and x's dtype runs (the model takes `plan`'s)."""
    global _FNS, LAUNCHES
    M, K = x2.shape
    N = w8.shape[1]
    sk, sn = w8.stride()
    rows_layout = sn != 1
    bf16 = x2.dtype == torch.bfloat16
    _check(bf16 if p.path == "tc" else (p.path == "rows") == rows_layout,
           lambda: f"{p} does not serve this call")
    _check(p.path != "rows" or rows_smem(p.mb, K) <= ROWS_SMEM_MAX,
           lambda: f"K = {K} is too large for the transposed layout")
    if _FNS is None:
        lib = LIBRARY.load()
        _FNS = (lib.int8_splitk_launch, lib.int8_rows_launch,
                lib.int8_tc_launch)
    y = torch.empty((M, N), dtype=torch.float32, device=x2.device)
    args = (x2.data_ptr(), w8.data_ptr(), scale.data_ptr(), y.data_ptr(),
            M, K, N, x2.stride(0))
    stream = cuda_stream(x2.device)
    if p.path == "tc":
        rc = _FNS[2](*args, sn if rows_layout else sk, int(rows_layout),
                     p.bn, p.cs, stream)
    elif p.path == "rows":
        rc = _FNS[1](*args, sn, p.mb, p.sms, int(bf16), stream)
    else:
        rc = _FNS[0](*args, sk, p.mb, p.cs, int(bf16), stream)
    if rc != 0:
        raise RuntimeError(f"int8 GEMV kernel launch failed ({p}): CUDA "
                           f"error {rc}")
    with COUNT_LOCK:
        LAUNCHES += 1
    return y


def _launch(x, w8, scale):
    """Check the call and launch the planned path; returns the f32
    (..., N) result."""
    K, N = w8.shape
    dev = x.device
    # (messages are built only when a check fails: this runs per call)
    _check(x.dtype in _X_DTYPES, lambda: f"x dtype {x.dtype}; supported "
           "float32 and bfloat16")
    _check(w8.dtype == torch.int8 and w8.dim() == 2, "w8 must be a 2-D "
           "int8 tensor")
    _check(x.shape[-1] == K, lambda: f"x has {x.shape[-1]} features, w8 "
           f"{K} rows")
    _check(scale.numel() == N and scale.dtype == torch.float32,
           lambda: f"scale must hold {N} float32 values")
    _check(w8.device == dev and scale.device == dev, lambda: (
        f"w8 / scale on {w8.device} / {scale.device}, x on {dev}"))
    sk, sn = w8.stride()
    _check(sn == 1 or sk == 1, lambda: (
        f"w8 strides {w8.stride()}: one of them must be 1 ((K, N) weights "
        "or a transposed (N, K) table)"))
    lead = x.shape[:-1]
    x2 = x.reshape(-1, K)
    if x2.stride(-1) != 1:
        x2 = x2.contiguous()
    M = x2.shape[0]
    if M * N == 0:
        return torch.zeros((*lead, N), dtype=torch.float32, device=dev)
    if not scale.is_contiguous():
        scale = scale.contiguous()
    p = plan(M, K, N, sn != 1, x2.dtype == torch.bfloat16, _n_sm(dev.index))
    return launch_plan(x2, w8, scale, p).reshape(*lead, N)


def int8_gemv(x, w8, scale):
    """`(x @ w8) * scale` in x's dtype; see the module docstring.

    CUDA tensors launch the Hopper kernel (or raise on what it does not
    take); CPU tensors run `int8_gemv_plain`."""
    if x.device.type == "cuda":
        y = _launch(x, w8, scale)
    elif x.device.type == "cpu":
        y = int8_gemv_plain(x, w8, scale)
    else:
        raise ValueError(f"int8 GEMV: unsupported device {x.device}")
    return y.to(x.dtype)
