"""Fused int8 dequantisation + GEMV: the Hopper kernel's wrapper, its
plain PyTorch version and the launch counter.

`int8_gemv(x, w8, scale)` computes `(x @ w8) * scale` with f32
accumulation: x (..., K) f32 or bf16; w8 a (K, N) int8 tensor or view —
the dense (K, N) weight, or the (V, D) embedding table as its transpose
`w8.t()` (the quantized tied-logits head); scale: N f32 per-output-column
scales of any shape with N elements ((1, N) for dense weights, (V, 1) for
the table). Returns (..., N) in x's dtype; the kernel's output is f32 and
is cast once.

On a CUDA tensor the wrapper launches the kernel of `csrc/int8_gemv.cu`
for any number of rows, or raises; on a CPU tensor it runs
`int8_gemv_plain`.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels.build import KernelLibrary

_X_DTYPES = (torch.float32, torch.bfloat16)
#: the kernel stages a row block of x as f32 in shared memory for the
#: transposed (unit stride along K) layout: rows * K * 4 bytes <= this
_ROWS_SMEM_MAX = 200 * 1024

#: kernel launches made by `int8_gemv` (a plain integer; reset it to 0
#: before a run whose launches should be counted)
LAUNCHES = 0


def _declare(lib):
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    fn = lib.int8_gemv_launch
    fn.argtypes = ([vp] * 4             # x w8 scale y
                   + [i32] * 3          # M K N
                   + [i64] * 3          # sx sk sn
                   + [i32] * 2          # mb x_bf16
                   + [vp])              # stream
    fn.restype = ctypes.c_int


#: the kernel's source and built library (`csrc/int8_gemv.cu`)
LIBRARY = KernelLibrary(
    "int8_gemv", Path(__file__).resolve().parent / "csrc" / "int8_gemv.cu",
    declare=_declare)


def int8_gemv_plain(x, w8, scale):
    """Plain PyTorch version: `(x.float() @ w8.float()) * scale`, f32,
    shaped (..., N)."""
    return (x.float() @ w8.float()) * scale.reshape(-1).float()


def _check(cond, msg):
    if not cond:
        raise ValueError(f"int8 GEMV kernel: {msg}")


def _rows_per_block(M: int) -> int:
    mb = 1
    while mb < min(M, 8):
        mb *= 2
    return mb


def _launch(x, w8, scale):
    K, N = w8.shape
    dev = x.device
    _check(x.dtype in _X_DTYPES, f"x dtype {x.dtype}; supported float32 "
           "and bfloat16")
    _check(w8.dtype == torch.int8 and w8.dim() == 2, "w8 must be a 2-D "
           "int8 tensor")
    _check(x.shape[-1] == K, f"x has {x.shape[-1]} features, w8 {K} rows")
    _check(scale.numel() == N and scale.dtype == torch.float32,
           f"scale must hold {N} float32 values")
    for name, t in (("w8", w8), ("scale", scale)):
        _check(t.device == dev, f"{name} is on {t.device}, x on {dev}")
    sk, sn = w8.stride()
    _check(sn == 1 or sk == 1, f"w8 strides {w8.stride()}: one of them "
           "must be 1 ((K, N) weights or a transposed (N, K) table)")
    lead = x.shape[:-1]
    x2 = x.reshape(-1, K)
    if x2.stride(-1) != 1:
        x2 = x2.contiguous()
    M = x2.shape[0]
    mb = _rows_per_block(M)
    if sn != 1:      # transposed layout: the row block is staged as f32
        kp = (K + 3) // 4 * 4
        while mb > 1 and mb * kp * 4 > _ROWS_SMEM_MAX:
            mb //= 2
        _check(mb * kp * 4 <= _ROWS_SMEM_MAX,
               f"K = {K} is too large for the transposed layout")
    scale = scale.reshape(-1).contiguous()
    y = torch.empty((M, N), dtype=torch.float32, device=dev)
    if M * N == 0:
        return y.zero_().reshape(*lead, N)
    fn = LIBRARY.load().int8_gemv_launch
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = fn(x2.data_ptr(), w8.data_ptr(), scale.data_ptr(), y.data_ptr(),
            M, K, N, x2.stride(0), sk, sn, mb,
            int(x2.dtype == torch.bfloat16), stream)
    if rc != 0:
        raise RuntimeError(f"int8 GEMV kernel launch failed: CUDA error {rc}")
    global LAUNCHES
    LAUNCHES += 1
    return y.reshape(*lead, N)


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
