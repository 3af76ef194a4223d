"""Mamba2 SSD scan: the Hopper kernel's wrappers, their plain PyTorch
versions, the path plan and the launch counter.

`ssd(x, dt, A, B, C, chunk, initial_state)` has the API of the JAX
package's `repro/kernels/ssd_scan/ops.py::ssd`:

  x   (b, L, H, P) f32 or bf16     dt (b, L, H) f32 (0 = masked token)
  A   (H,) f32 (negative)          B, C (b, L, G, N) in x's dtype, H % G == 0
  initial_state (b, H, P, N) f32 or None (zeros)
  -> y (b, L, H, P) in x's dtype, final_state (b, H, P, N) f32

`ssd_slots(x, dt, A, B, C, chunk, state, slot_idx=None, write=True)` is
the same scan with the state read and written IN PLACE: request b starts
from `state[slot_idx[b]]` (`state[b]` without `slot_idx`; zeros for
`state=None`) and, with `write`, its final state replaces those rows.
`write=False` writes no state at all. Returns y. Rows no request names
are never touched; padding rows that share one slot race among
themselves only (their outputs are undefined, as on the cache paths).

On a CUDA tensor both wrappers launch the kernel of `csrc/ssd_scan.cu`
(or raise on what it does not take); on a CPU tensor they run
`ssd_chunked`, a transcription of the reference's chunked algorithm
(`repro/models/ssm.py::ssd_chunked`) with a Python loop over chunks in
place of `lax.scan`, and `ssd_slots_plain`.

A call that asks for a gradient (grad mode on, an input that requires
one) goes through `scan` (`SSDScanFunction`): the same forward, and
`ssd_grad`, the chunked scan's adjoint in tensor ops (the TPU kernel had
no backward; the reference differentiates its chunked scan with XLA's
autodiff). Only `ssd` and `ssd_slots` with `state=None` (a full sequence
from zeros: training) take it; a call that carries a state in place
refuses a gradient on CUDA.

`plan` picks the kernel's path from the shapes and the dtype alone: the
recurrence for sequences of up to `rec_max_l(N)` tokens (decode,
verification, commits), the tensor-core chunk path above; the rows of
the state each block owns (`pb`) and the chunk length (`q`). It never
looks at the state pool's capacity or at `slot_idx`, so a resident pool
and a paged cache's slot leaves give the same bits. The kernel's chunk
length is its own; the plain version uses `chunk`. The function does not
depend on either beyond the order of f32 sums. `launch_plan` launches one
given plan; `chip_smoke.py` times the two paths against each other
through it.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import NamedTuple

import torch

from repro_torch.kernels.build import (COUNT_LOCK, CSRC, SMEM_LIMIT,
                                      KernelLibrary, cuda_stream,
                                      refuse_grad)

_X_DTYPES = (torch.float32, torch.bfloat16)
#: d_state values the kernel takes (powers of two: a thread's columns of
#: a state row are whole 16-byte vectors, a row's lanes a power of two)
SUPPORTED_N = (8, 16, 32, 64, 128, 256)
#: sequences of at most REC_MAX_L tokens (REC_MAX_L_SMALL_N at d_state
#: N <= 32) run the recurrence, longer ones the tensor-core chunk path: a
#: token of the recurrence costs
#: 5 P N f32 operations, so it wins longer at a small state. Measured by
#: `chip_smoke.py`'s crossover at 4 requests (NVIDIA H100 80GB HBM3,
#: 700 W; PERF.md §6): at mamba2-130m's N = 128 the recurrence is faster
#: up to 12 tokens (0.0123 against 0.0151 ms) and the two are tied at 16
#: (0.0152 against 0.0149); at jamba's N = 16 it is faster up to 24
#: (0.0138 against 0.0169), and at 32-48 tokens the faster path changed
#: between runs.
#: Every serving form but prefill chunks (decode, verification, commits)
#: is at most 6 tokens.
REC_MAX_L, REC_MAX_L_SMALL_N = 12, 24
#: the recurrence path's most threads a block, the tokens it stages in
#: shared memory at a time, and the state columns each thread holds (8:
#: half the blocks of 4 at the same threads; `chip_smoke.py` timed
#: verification at 4 requests at 0.0079 ms against 0.0103 with 4 at
#: mamba2's widths, 0.0054 against 0.0062 at jamba's, NVIDIA H100 80GB
#: HBM3, 700 W; PERF.md §6)
REC_THREADS, REC_TOKENS, REC_COLUMNS = 256, 16, 8
#: the chunk path's threads: 16 warps where the plan puts one block on an
#: SM, 8 where it puts two; and its longest chunk
CHUNK_THREADS_ONE, CHUNK_THREADS_TWO, CHUNK_Q_MAX = 512, 256, 64
#: shared memory of one H100 SM (228 KB), of which each resident block
#: also reserves 1 KB; the 256-thread chunk kernel's registers allow two
#: blocks an SM
SMEM_PER_SM, SMEM_RESERVED, CHUNK_BLOCKS_PER_SM = 233472, 1024, 2
#: the chunk path's state slice: pb * N floats at most
STATE_TILE_MAX = 2048
#: the SMs a plan tries to fill (the H100's 132)
N_SM = 132

#: kernel launches made by `ssd` and `ssd_slots` (a plain integer; reset
#: it to 0 before a run whose launches should be counted)
LAUNCHES = 0


def _declare(lib):
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    fn = lib.ssd_scan_launch
    fn.argtypes = ([vp] * 9             # x dt A B C state_in state_out idx y
                   + [i32] * 7          # rows b L H P G N
                   + [i32] * 4          # chunk_path Q Pb threads
                   + [i64] * 12         # x, dt, B, C strides (b, l, h|g)
                   + [i32] + [vp])      # bf16, stream
    fn.restype = ctypes.c_int
    ip = ctypes.POINTER(ctypes.c_int)
    lib.ssd_smem.argtypes = [i32] * 6 + [ip] * 3   # path thr Q N Pb bf16
    lib.ssd_smem.restype = ctypes.c_int


#: the kernel's source and built library (`csrc/ssd_scan.cu`)
LIBRARY = KernelLibrary(
    "ssd_scan", Path(__file__).resolve().parent / "csrc" / "ssd_scan.cu",
    headers=[CSRC / "smem_report.cuh"], declare=_declare)


# =====================================================================
# plain versions
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


def ssd_slots_plain(x, dt, A, B, C, chunk, state, slot_idx=None,
                    write=True):
    """Plain version of `ssd_slots`: gather the named rows of `state`
    (the first b without `slot_idx`), scan them with `ssd_chunked` and,
    with `write`, scatter the final state back into those rows. Returns
    y."""
    b = x.shape[0]
    if state is None:
        init = None
    elif slot_idx is None:
        init = state[:b]
    else:
        init = state.index_select(0, slot_idx.long())
    y, final = ssd_chunked(x, dt, A, B, C, chunk, init)
    if write and state is not None:
        if slot_idx is None:
            state[:b].copy_(final)
        else:
            state[slot_idx.long()] = final.to(state.dtype)
    return y


# =====================================================================
# path planning (plain Python, tested on the CPU)
# =====================================================================

class Plan(NamedTuple):
    """One launch: `path` "rec" (the recurrence) or "chunk" (the dual form
    on tensor cores); `pb` state rows (columns of x) per block, the grid
    being (P / pb, H, b); `q` the chunk length (chunk path) or the tokens
    staged at a time (recurrence); `threads` per block; `smem` the
    dynamic shared memory in bytes."""
    path: str
    pb: int
    q: int
    threads: int
    smem: int


def _align16(v: int) -> int:
    return (v + 15) // 16 * 16


def chunk_smem(q: int, N: int, pb: int, esize: int) -> int:
    """Dynamic shared memory of the chunk path (the kernel's `ChunkSmem`):
    two stages of B and C (q x np) and x (q x xp) in x's type and dt, then
    f32 scores (q x (q + 4)), the state slice (pb x (npad + 4)), the
    inter-chunk y (q x xp) and three q-vectors; every region on 16
    bytes."""
    npad = max(N, 16)
    np_ = npad + (4 if esize == 4 else 8)
    xp = pb if pb % 16 == 8 else pb + 8
    stage = (2 * _align16(q * np_ * esize) + _align16(q * xp * esize)
             + _align16(q * 4))
    return (2 * stage + _align16(q * (q + 4) * 4)
            + _align16(pb * (npad + 4) * 4) + _align16(q * xp * 4)
            + 3 * _align16(q * 4))


def rec_smem(N: int, pb: int) -> int:
    """Dynamic shared memory of the recurrence: REC_TOKENS tokens of B, C
    (N each), x (pb) and dt, f32."""
    return REC_TOKENS * (2 * N + pb + 1) * 4


def _pow2_divisor(P: int, cap: int) -> int:
    """The largest power of two that divides P and is at most cap."""
    d = 1
    while d * 2 <= cap and P % (d * 2) == 0:
        d *= 2
    return d


def rec_plan(P: int, N: int) -> Plan:
    """The recurrence: REC_COLUMNS columns of a state row a thread (a
    row's N / REC_COLUMNS threads one power-of-two group of lanes), as
    many rows a block as fit REC_THREADS."""
    tpr = N // REC_COLUMNS
    pb = _pow2_divisor(P, REC_THREADS // tpr)
    return Plan("rec", pb, REC_TOKENS, pb * tpr, rec_smem(N, pb))


def chunk_blocks_per_sm(smem: int) -> int:
    """256-thread chunk-path blocks one SM holds at once with `smem`
    bytes each."""
    return min(CHUNK_BLOCKS_PER_SM, SMEM_PER_SM // (smem + SMEM_RESERVED))


def slice_max(P: int, N: int) -> int:
    """The chunk path's widest state slice: 8 rows, or as many as
    STATE_TILE_MAX / N, dividing P."""
    return _pow2_divisor(P, max(8, STATE_TILE_MAX // N))


def chunk_plan(b: int, L: int, H: int, P: int, N: int, esize: int) -> Plan:
    """The chunk path. Chunks of 64 tokens, else 32 (no longer than L
    rounded up to 16), and the narrowest state slice (8 rows, up to
    STATE_TILE_MAX / N) whose blocks fit one an SM, each of 16 warps;
    else the same search for blocks that fit two an SM, each of 8 warps;
    else 32-token chunks, the widest slice and 8 warps. Wider slices
    re-read B and C and recompute the scores fewer times, a single wave
    leaves no tail, and a lone block on an SM hides latency with its own
    warps (measured: PERF.md §6)."""
    pb_max = slice_max(P, N)
    for threads, per_sm in ((CHUNK_THREADS_ONE, lambda smem: 1),
                            (CHUNK_THREADS_TWO, chunk_blocks_per_sm)):
        for q in (CHUNK_Q_MAX, 32):
            q = min(q, _align16(L))
            pb = 8
            while pb <= pb_max:
                smem = chunk_smem(q, N, pb, esize)
                if (smem <= SMEM_LIMIT
                        and (P // pb) * H * b <= N_SM * per_sm(smem)):
                    return Plan("chunk", pb, q, threads, smem)
                pb *= 2
    q = min(32, _align16(L))
    return Plan("chunk", pb_max, q, CHUNK_THREADS_TWO,
                chunk_smem(q, N, pb_max, esize))


def rec_max_l(N: int) -> int:
    """The longest sequence the recurrence takes at d_state N."""
    return REC_MAX_L_SMALL_N if N <= 32 else REC_MAX_L


@functools.lru_cache(maxsize=4096)
def plan(b: int, L: int, H: int, P: int, G: int, N: int,
         dtype: torch.dtype) -> Plan:
    """The kernel's path and tiling for x (b, L, H, P) and B, C
    (b, L, G, N) in `dtype`, from the shapes alone."""
    if L <= rec_max_l(N):
        return rec_plan(P, N)
    return chunk_plan(b, L, H, P, N, 2 if dtype == torch.bfloat16 else 4)


# =====================================================================
# kernel wrapper
# =====================================================================

def _check(cond, msg):
    """Raise on a failed check; `msg` is a string or a callable that
    builds it."""
    if not cond:
        raise ValueError(f"SSD scan kernel: "
                         f"{msg() if callable(msg) else msg}")


def _aligned(t, v: int) -> bool:
    """Unit stride along the last dim, the other strides whole 16-byte
    vectors of v elements, and a 16-byte aligned start."""
    return (t.stride(-1) == 1 and all(s % v == 0 for s in t.stride()[:-1])
            and t.data_ptr() % 16 == 0)


def _check_state(t, H, P, N, dev, name):
    # (the recurrence moves state rows as 16-byte vectors)
    _check(t.dim() == 4 and tuple(t.shape[1:]) == (H, P, N)
           and t.dtype == torch.float32 and t.is_contiguous()
           and t.data_ptr() % 16 == 0,
           lambda: f"{name} must be a contiguous, 16-byte aligned (rows, "
           f"{H}, {P}, {N}) float32 tensor, got {tuple(t.shape)} {t.dtype}")
    _check(t.device == dev, lambda: f"{name} is on {t.device}, x on {dev}")


_FN = None


def launch_plan(x, dt, A, B, C, state_in, state_out, slot_idx, p: Plan):
    """Check the call and launch plan `p`: the state read from
    `state_in` and written to `state_out` (either None, or both one
    tensor), rows `slot_idx[b]` or b. Returns y. Any plan that covers P
    runs (the wrappers take `plan`'s). Every slot must be a row of the
    state: the kernel stops with a CUDA error on one outside it, as an
    index outside a gather does."""
    global _FN, LAUNCHES
    dev = x.device
    refuse_grad("SSD scan kernel", "a scan that carries a state in "
                "place has no gradient (the reference never "
                "differentiates one); a full sequence with state=None "
                "differentiates through `scan`", x, dt, A, B, C, state_in)
    # (messages are built only when a check fails: this runs per call)
    _check(x.dim() == 4 and dt.dim() == 3 and B.dim() == 4
           and C.shape == B.shape, "x (b, L, H, P), dt (b, L, H), "
           "B/C (b, L, G, N) expected")
    b, L, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    _check(tuple(dt.shape) == (b, L, H), lambda: f"dt shape "
           f"{tuple(dt.shape)}")
    _check(tuple(B.shape[:2]) == (b, L), lambda: f"B/C shape "
           f"{tuple(B.shape)}")
    _check(G > 0 and H % G == 0, lambda: f"{H} heads are not a multiple "
           f"of {G} groups")
    _check(tuple(A.shape) == (H,), lambda: f"A shape {tuple(A.shape)}")
    _check(L > 0 and b > 0, "empty batch or sequence")
    _check(x.dtype in _X_DTYPES, lambda: f"x dtype {x.dtype}; supported "
           "float32 and bfloat16")
    _check(B.dtype == x.dtype and C.dtype == x.dtype, lambda: (
        f"B/C dtypes {B.dtype}, {C.dtype}; x, B and C must share a dtype"))
    _check(dt.dtype == torch.float32 and A.dtype == torch.float32,
           "dt and A must be float32")
    _check(N in SUPPORTED_N, lambda: f"d_state N = {N} is not supported "
           f"(one of {SUPPORTED_N})")
    _check(P % 8 == 0, lambda: f"head dim P = {P} is not a multiple of 8")
    for name, t in (("dt", dt), ("A", A), ("B", B), ("C", C),
                    ("slot_idx", slot_idx)):
        _check(t is None or t.device == dev, lambda: (
            f"{name} is on {t.device}, x on {dev}"))
    for name, t in (("state", state_in), ("state", state_out)):
        if t is not None:
            _check_state(t, H, P, N, dev, name)
    if slot_idx is not None:
        _check(tuple(slot_idx.shape) == (b,), lambda: (
            f"slot_idx shape {tuple(slot_idx.shape)}, batch {b}"))
        if slot_idx.dtype != torch.int32:
            slot_idx = slot_idx.to(torch.int32)
        slot_idx = slot_idx.contiguous()
    else:
        for t in (state_in, state_out):
            _check(t is None or t.shape[0] >= b, lambda: (
                f"the state has {t.shape[0]} rows for a batch of {b}"))
    _check(p.pb >= 8 and P % p.pb == 0 and p.path in ("rec", "chunk")
           and (p.path == "rec" or p.threads in (CHUNK_THREADS_ONE,
                                                 CHUNK_THREADS_TWO)),
           lambda: f"{p} does not cover P = {P}")
    v = 16 // x.element_size()
    x, B, C = (t if _aligned(t, v) else t.contiguous() for t in (x, B, C))
    A = A.contiguous()
    y = torch.empty((b, L, H, P), dtype=x.dtype, device=dev)
    st = state_in if state_in is not None else state_out
    rows = st.shape[0] if st is not None else 2 ** 31 - 1
    if _FN is None:
        _FN = LIBRARY.load().ssd_scan_launch
    rc = _FN(x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
             C.data_ptr(),
             None if state_in is None else state_in.data_ptr(),
             None if state_out is None else state_out.data_ptr(),
             None if slot_idx is None else slot_idx.data_ptr(),
             y.data_ptr(), rows, b, L, H, P, G, N,
             int(p.path == "chunk"), p.q, p.pb, p.threads,
             *x.stride()[:3], *dt.stride(), *B.stride()[:3],
             *C.stride()[:3], int(x.dtype == torch.bfloat16),
             cuda_stream(dev))
    if rc != 0:
        raise RuntimeError(f"SSD scan kernel launch failed ({p}): CUDA "
                           f"error {rc}")
    with COUNT_LOCK:
        LAUNCHES += 1
    return y


def plan_for(x, B) -> Plan:
    """`plan` for the shapes and dtype of x and B (what the wrappers
    launch)."""
    b, L, H, P = x.shape
    return plan(b, L, H, P, B.shape[2], B.shape[3], x.dtype)


def _wants_grad(*tensors) -> bool:
    """Grad mode is on and one of `tensors` (None allowed) requires a
    gradient."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def ssd(x, dt, A, B, C, chunk, initial_state=None):
    """(y, final_state) of the SSD scan; see the module docstring.

    CUDA tensors launch the Hopper kernel (or raise on what it does not
    take); CPU tensors run `ssd_chunked` with chunk length `chunk`. A
    call that asks for a gradient goes through `scan`."""
    if _wants_grad(x, dt, A, B, C, initial_state):
        return scan(x, dt, A, B, C, chunk, initial_state)
    if x.device.type == "cuda":
        b, _, H, P = x.shape
        final = torch.empty((b, H, P, B.shape[-1]), dtype=torch.float32,
                            device=x.device)
        if initial_state is not None and not initial_state.is_contiguous():
            initial_state = initial_state.contiguous()
        y = launch_plan(x, dt, A, B, C, initial_state, final, None,
                        plan_for(x, B))
        return y, final
    if x.device.type == "cpu":
        return ssd_chunked(x, dt, A, B, C, chunk, initial_state)
    raise ValueError(f"SSD scan: unsupported device {x.device}")


def ssd_slots(x, dt, A, B, C, chunk, state, slot_idx=None, write=True):
    """y of the SSD scan with the state read and, with `write`, written
    in place in `state` (rows, H, P, N) f32 at rows `slot_idx` (or the
    first b rows); see the module docstring. Each slot must be a row of
    `state` (0 <= slot_idx[b] < rows): on CUDA one outside stops the
    kernel with a CUDA error, on the CPU the gather raises.

    CUDA tensors launch the Hopper kernel (or raise on what it does not
    take); CPU tensors run `ssd_slots_plain` with chunk length `chunk`.
    With `state=None` (a full sequence from zeros, the training forward)
    a call that asks for a gradient goes through `scan`; one that carries
    a state refuses it on CUDA (the reference never differentiates a
    carried state)."""
    if state is None and _wants_grad(x, dt, A, B, C):
        return scan(x, dt, A, B, C, chunk)[0]
    if x.device.type == "cuda":
        return launch_plan(x, dt, A, B, C, state,
                           state if write else None, slot_idx,
                           plan_for(x, B))
    if x.device.type == "cpu":
        return ssd_slots_plain(x, dt, A, B, C, chunk, state, slot_idx,
                               write)
    raise ValueError(f"SSD scan: unsupported device {x.device}")


# =====================================================================
# the gradient of the scan
# =====================================================================

def _chunks(t, nc, chunk):
    """(b, Lp, ...) -> (b, nc, chunk, ...) in f32."""
    return t.reshape(t.shape[0], nc, chunk, *t.shape[2:]).float()


def ssd_grad(x, dt, A, B, C, chunk, initial_state, dy, dfinal):
    """(dx, ddt, dA, dB, dC, dinit) of `ssd_chunked` given the gradients
    dy (b, L, H, P) of y and dfinal (b, H, P, N) of the final state
    (either None: zeros): the chunked scan's adjoint in tensor ops, f32,
    chunk by chunk with the forward's `chunk`. dinit is None without an
    initial state; each other gradient is in its input's dtype.

    Per (b, h) and chunk, with a_j = dt_j A, cum its running sum in the
    chunk, L_ij = exp(cum_i - cum_j) (i >= j), S_ij = (C_i . B_j) L_ij,
    u_j = dt_j x_j, s_c the state before chunk c and G_c its gradient:
    the states come from a forward loop, G_c = exp(cum_Q) G_{c+1} +
    sum_i exp(cum_i) dy_i (x) C_i from a reverse one; then within each
    chunk (G = G_{c+1})
      du_j = sum_{i>=j} S_ij dy_i + exp(cum_Q - cum_j) G B_j,
      dC_i = sum_{j<=i} L_ij (dy_i . u_j) B_j + exp(cum_i) s_c^T dy_i,
      dB_j = sum_{i>=j} L_ij (dy_i . u_j) C_i + exp(cum_Q - cum_j) G^T u_j,
    and the gradient of cum from every exp that reads it, summed back
    over the chunk into a (da = reverse cumulative sum of dcum)."""
    b, L, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    dev = x.device
    chunk = min(chunk, L)
    pad = (-L) % chunk
    nc = (L + pad) // chunk
    rep = H // G

    def padded(t):
        if t is None or not pad:
            return t
        return torch.nn.functional.pad(t, (0, 0) * (t.dim() - 2)
                                       + (0, pad))

    xc = _chunks(padded(x), nc, chunk)                         # (b,c,Q,H,P)
    dtc = _chunks(padded(dt), nc, chunk)                       # (b,c,Q,H)
    Bh = _chunks(padded(B), nc, chunk).repeat_interleave(rep, dim=3)
    Ch = _chunks(padded(C), nc, chunk).repeat_interleave(rep, dim=3)
    dyc = (torch.zeros_like(xc) if dy is None
           else _chunks(padded(dy), nc, chunk))
    Af = A.float()
    u = xc * dtc[..., None]
    cum = torch.cumsum(dtc * Af, dim=2)                        # (b,c,Q,H)
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]        # (b,c,Q,Q,H)
    causal = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                   device=dev))
    Lmat = torch.exp(seg.masked_fill(~causal[None, None, :, :, None],
                                     float("-inf")))
    del seg
    S = torch.einsum("bcihn,bcjhn->bcijh", Ch, Bh) * Lmat
    to_end = torch.exp(cum[:, :, -1:, :] - cum)                # (b,c,Q,H)
    in_decay = torch.exp(cum)
    chunk_decay = in_decay[:, :, -1]                           # (b,c,H)

    # the states before each chunk, as the forward makes them
    contrib = torch.einsum("bcqhn,bcqh,bcqhp->bchpn", Bh, to_end, u)
    s = (torch.zeros((b, H, P, N), dtype=torch.float32, device=dev)
         if initial_state is None else initial_state.float())
    before = []
    for c in range(nc):
        before.append(s)
        s = s * chunk_decay[:, c, :, None, None] + contrib[:, c]
    s_before = torch.stack(before, dim=1)                      # (b,c,H,P,N)
    del contrib, before

    # the reverse recurrence: the gradient of the state after each chunk
    to_state = torch.einsum("bcqhp,bcqhn,bcqh->bchpn", dyc, Ch, in_decay)
    g = (torch.zeros((b, H, P, N), dtype=torch.float32, device=dev)
         if dfinal is None else dfinal.float())
    after = [None] * nc
    for c in range(nc - 1, -1, -1):
        after[c] = g
        g = g * chunk_decay[:, c, :, None, None] + to_state[:, c]
    g_after = torch.stack(after, dim=1)                        # (b,c,H,P,N)
    del to_state, after

    dyu = torch.einsum("bcihp,bcjhp->bcijh", dyc, u)           # dy_i . u_j
    gB = torch.einsum("bchpn,bcjhn->bcjhp", g_after, Bh)       # G B_j
    du = (torch.einsum("bcijh,bcihp->bcjhp", S, dyc)
          + to_end[..., None] * gB)
    M = dyu * Lmat
    del Lmat
    sdy = torch.einsum("bchpn,bcihp->bcihn", s_before, dyc)    # s_c^T dy_i
    dC = (torch.einsum("bcijh,bcjhn->bcihn", M, Bh)
          + in_decay[..., None] * sdy)
    dB = (torch.einsum("bcijh,bcihn->bcjhn", M, Ch)
          + to_end[..., None]
          * torch.einsum("bchpn,bcjhp->bcjhn", g_after, u))
    del M

    W = dyu * S
    del dyu, S
    dcum = W.sum(dim=3) - W.sum(dim=2)
    del W
    dcum = dcum + in_decay * (sdy * Ch).sum(-1)
    w = to_end * (u * gB).sum(-1)                              # (b,c,Q,H)
    dcum = dcum - w
    dcum[:, :, -1] += (w.sum(dim=2) + chunk_decay
                       * (g_after * s_before).sum((-1, -2)))
    da = torch.flip(torch.cumsum(torch.flip(dcum, [2]), dim=2), [2])

    ddt = Af * da + (xc * du).sum(-1)
    dx = du * dtc[..., None]
    dA = (dtc * da).sum((0, 1, 2))

    def back(t, like):
        t = t.reshape(b, nc * chunk, *t.shape[3:])[:, :L]
        return t.to(like.dtype)

    def groups(t, like):
        return back(t.reshape(*t.shape[:3], G, rep, N).sum(4), like)

    dinit = None if initial_state is None else g.to(initial_state.dtype)
    return (back(dx, x), back(ddt, dt), dA.to(A.dtype), groups(dB, B),
            groups(dC, C), dinit)


class SSDScanFunction(torch.autograd.Function):
    """The SSD scan with a gradient. The forward is the Hopper kernel on
    CUDA tensors (`launch_plan`, the same launch as `ssd`: autograd runs
    it with grad mode off) and `ssd_chunked` on CPU tensors; the backward
    `ssd_grad`: tensor ops, the counterpart of the reference's autodiff
    through its chunked scan (the TPU kernel had no backward)."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C, chunk, initial_state):
        y, final = ssd(x, dt, A, B, C, chunk, initial_state)
        ctx.save_for_backward(x, dt, A, B, C, initial_state)
        ctx.chunk = chunk
        return y, final

    @staticmethod
    def backward(ctx, dy, dfinal):
        x, dt, A, B, C, initial_state = ctx.saved_tensors
        grads = ssd_grad(x, dt, A, B, C, ctx.chunk, initial_state, dy,
                         dfinal)
        return (*grads[:5], None, grads[5])


def scan(x, dt, A, B, C, chunk, initial_state=None):
    """(y, final_state) of the SSD scan, differentiable in every input
    and the initial state (`SSDScanFunction`); the arguments are `ssd`'s."""
    return SSDScanFunction.apply(x, dt, A, B, C, chunk, initial_state)
