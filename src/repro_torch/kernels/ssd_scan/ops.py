"""Mamba2 SSD chunked scan: the Hopper kernel's wrapper, its plain PyTorch
version and the launch counter.

`ssd(x, dt, A, B, C, chunk, initial_state)` has the API of the JAX
package's `repro/kernels/ssd_scan/ops.py::ssd`:

  x   (b, L, H, P) f32 or bf16     dt (b, L, H) f32 (0 = masked token)
  A   (H,) f32 (negative)          B, C (b, L, G, N) in x's dtype, H % G == 0
  initial_state (b, H, P, N) f32 or None (zeros)
  -> y (b, L, H, P) in x's dtype, final_state (b, H, P, N) f32

On a CUDA tensor the wrapper launches the kernel of `csrc/ssd_scan.cu`
(or raises on what it does not take); on a CPU tensor it runs
`ssd_chunked`, a transcription of the reference's chunked algorithm
(`repro/models/ssm.py::ssd_chunked`) with a Python loop over chunks in
place of `lax.scan`.

The kernel walks the sequence in chunks of its own length (at most 64
tokens, fewer where shared memory demands it); the plain version uses
`chunk`. The function does not depend on the chunk length beyond the
order of f32 sums.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels.build import KernelLibrary

_X_DTYPES = (torch.float32, torch.bfloat16)
THREADS = 256
#: the kernel's largest inner chunk; smaller where the tiles would not fit
KERNEL_CHUNK = 64
#: dynamic shared memory a block may ask for (of the H100's 227 KB)
SMEM_MAX = 200 * 1024

#: kernel launches made by `ssd` (a plain integer; reset it to 0 before
#: a run whose launches should be counted)
LAUNCHES = 0


def _declare(lib):
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    fn = lib.ssd_scan_launch
    fn.argtypes = ([vp] * 8             # x dt A B C init y final
                   + [i32] * 7          # b L H P G N Q
                   + [i64] * 12         # x, dt, B, C strides (b, l, h|g)
                   + [i32] * 2          # bf16 smem_bytes
                   + [vp])              # stream
    fn.restype = ctypes.c_int


#: the kernel's source and built library (`csrc/ssd_scan.cu`)
LIBRARY = KernelLibrary(
    "ssd_scan", Path(__file__).resolve().parent / "csrc" / "ssd_scan.cu",
    declare=_declare)


# =====================================================================
# plain version
# =====================================================================

def ssd_chunked(x, dt, A, B, C, chunk, initial_state=None):
    """Chunked SSD scan, the reference's algorithm in PyTorch.

    Within a chunk the dual form: y_intra = (C Bᵀ ⊙ exp(segsum)) (x dt);
    across chunks the (b, H, P, N) state, decayed by exp(sum of dt A)
    over each chunk. Returns (y in x's dtype, final_state f32)."""
    b, L, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    chunk = min(chunk, L)          # decode (L=1) degenerates to the recurrence
    pad = (-L) % chunk
    if pad:
        x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad))
        dt = torch.nn.functional.pad(dt, (0, 0, 0, pad))
        B = torch.nn.functional.pad(B, (0, 0, 0, 0, 0, pad))
        C = torch.nn.functional.pad(C, (0, 0, 0, 0, 0, pad))
    Lp = L + pad
    nc = Lp // chunk
    rep = H // G

    xc = x.reshape(b, nc, chunk, H, P).float()
    dtc = dt.reshape(b, nc, chunk, H).float()
    Bh = B.reshape(b, nc, chunk, G, N).float().repeat_interleave(rep, dim=3)
    Ch = C.reshape(b, nc, chunk, G, N).float().repeat_interleave(rep, dim=3)

    dA_cum = torch.cumsum(dtc * A.float(), dim=2)               # (b,nc,Q,H)

    # intra-chunk: L[i, j] = exp(cum[i] - cum[j]) for i >= j, else 0; the
    # mask goes in before exp (cum[i] - cum[j] > 0 above the diagonal)
    seg = dA_cum[:, :, :, None, :] - dA_cum[:, :, None, :, :]   # (b,nc,Q,Q,H)
    causal = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                   device=x.device))
    Lmat = torch.exp(seg.masked_fill(~causal[None, None, :, :, None],
                                     float("-inf")))
    scores = torch.einsum("bcihn,bcjhn->bcijh", Ch, Bh) * Lmat
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", scores,
                           xc * dtc[..., None])

    # each chunk's own contribution to the state at its end
    decay_to_end = torch.exp(dA_cum[:, :, -1:, :] - dA_cum)     # (b,nc,Q,H)
    state_c = torch.einsum("bcqhn,bcqh,bcqhp->bchpn", Bh,
                           decay_to_end * dtc, xc)

    # inter-chunk recurrence (the reference's lax.scan)
    chunk_decay = torch.exp(dA_cum[:, :, -1, :])                # (b,nc,H)
    s = (torch.zeros((b, H, P, N), dtype=torch.float32, device=x.device)
         if initial_state is None else initial_state.float())
    before = []
    for c in range(nc):
        before.append(s)
        s = s * chunk_decay[:, c, :, None, None] + state_c[:, c]
    s_before = torch.stack(before, dim=1)                       # (b,nc,H,P,N)

    y_inter = torch.einsum("bcqhn,bchpn,bcqh->bcqhp", Ch, s_before,
                           torch.exp(dA_cum))
    y = (y_intra + y_inter).reshape(b, Lp, H, P)[:, :L]
    return y.to(x.dtype), s


# =====================================================================
# kernel wrapper
# =====================================================================

def _check(cond, msg):
    if not cond:
        raise ValueError(f"SSD scan kernel: {msg}")


def kernel_chunk(P: int, N: int, L: int) -> int:
    """The kernel's inner chunk length: the largest power of two up to
    KERNEL_CHUNK whose tiles fit SMEM_MAX, no longer than L."""
    q = KERNEL_CHUNK
    while q > 1 and smem_bytes(P, N, q) > SMEM_MAX:
        q //= 2
    return max(1, min(q, L))


def smem_bytes(P: int, N: int, Q: int) -> int:
    """Dynamic shared memory of one block: B and C tiles (Q, N+1), x
    (Q, P), the state (P, N+1), scores (Q, Q+1) and three Q-vectors, f32
    (rows padded by one word against bank conflicts)."""
    return 4 * (2 * Q * (N + 1) + Q * P + P * (N + 1) + Q * (Q + 1) + 3 * Q)


def _unit_last(t):
    return t if t.stride(-1) == 1 else t.contiguous()


def _launch(x, dt, A, B, C, initial_state):
    b, L, H, P = x.shape
    dev = x.device
    _check(x.dim() == 4 and dt.dim() == 3 and B.dim() == 4
           and C.shape == B.shape, "x (b, L, H, P), dt (b, L, H), "
           "B/C (b, L, G, N) expected")
    G, N = B.shape[2], B.shape[3]
    _check(tuple(dt.shape) == (b, L, H), f"dt shape {tuple(dt.shape)}")
    _check(tuple(B.shape[:2]) == (b, L), f"B/C shape {tuple(B.shape)}")
    _check(G > 0 and H % G == 0, f"{H} heads are not a multiple of {G} "
           "groups")
    _check(tuple(A.shape) == (H,), f"A shape {tuple(A.shape)}")
    _check(L > 0 and b > 0, "empty batch or sequence")
    _check(x.dtype in _X_DTYPES, f"x dtype {x.dtype}; supported float32 "
           "and bfloat16")
    _check(B.dtype == x.dtype and C.dtype == x.dtype,
           f"B/C dtypes {B.dtype}, {C.dtype}; x, B and C must share a "
           "dtype")
    _check(dt.dtype == torch.float32 and A.dtype == torch.float32,
           "dt and A must be float32")
    if initial_state is not None:
        _check(tuple(initial_state.shape) == (b, H, P, N)
               and initial_state.dtype == torch.float32,
               "initial_state must be (b, H, P, N) float32")
    for name, t in (("dt", dt), ("A", A), ("B", B), ("C", C),
                    ("initial_state", initial_state)):
        _check(t is None or t.device == dev,
               f"{name} is on {t.device if t is not None else None}, x on "
               f"{dev}")
    Q = kernel_chunk(P, N, L)
    smem = smem_bytes(P, N, Q)
    _check(smem <= SMEM_MAX, f"P = {P}, N = {N}: the state tile does not "
           "fit in shared memory")
    x, dt, B, C = (_unit_last(t) for t in (x, dt, B, C))
    A = A.contiguous()
    init = (None if initial_state is None
            else initial_state.contiguous())
    y = torch.empty((b, L, H, P), dtype=x.dtype, device=dev)
    final = torch.empty((b, H, P, N), dtype=torch.float32, device=dev)
    fn = LIBRARY.load().ssd_scan_launch
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
            C.data_ptr(), None if init is None else init.data_ptr(),
            y.data_ptr(), final.data_ptr(),
            b, L, H, P, G, N, Q,
            *x.stride()[:3], *dt.stride()[:3], *B.stride()[:3],
            *C.stride()[:3],
            int(x.dtype == torch.bfloat16), smem, stream)
    if rc != 0:
        raise RuntimeError(f"SSD scan kernel launch failed: CUDA error {rc}")
    global LAUNCHES
    LAUNCHES += 1
    return y, final


def ssd(x, dt, A, B, C, chunk, initial_state=None):
    """(y, final_state) of the SSD scan; see the module docstring.

    CUDA tensors launch the Hopper kernel (or raise on what it does not
    take); CPU tensors run `ssd_chunked` with chunk length `chunk`."""
    if x.device.type == "cuda":
        return _launch(x, dt, A, B, C, initial_state)
    if x.device.type == "cpu":
        return ssd_chunked(x, dt, A, B, C, chunk, initial_state)
    raise ValueError(f"SSD scan: unsupported device {x.device}")
