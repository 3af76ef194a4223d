"""Attention partials over a paged KV pool: the Hopper kernel's wrapper,
its plain PyTorch version and the launch counter.

`paged_attend_partial` is the entry point the model calls for every read
of a page pool. Its layout is the model's, as for
`flash_attention.ops.attend_partial`:

  q          (B, T, Hkv, G, Dk)  GQA group folded into the query
  k, v       (P, ps, Hkv, Dk/Dv) physical page pool
  q_pos      (B, T) int32; page_pos (P, ps) int32, -1 = empty row
  page_view  (B, n_view) int32 block table: logical page i of request b
             is physical page page_view[b, i] (unmapped entries point at
             a NULL page whose positions stay -1)
  k_scale, v_scale  (P, ps, Hkv) f32 with an int8 pool (one scale per
             row and head), read through the same block table
  -> m, l (B, T, Hkv, G) f32; acc (B, T, Hkv, G, Dv) f32

The read is causal, with an optional window. T = 1 is the decode form of
the reference's `paged_flash_decode`; T > 1 serves verification's cache
pass, commit and prefill on the pool. `paged_flash_decode` below is the
reference's (B, Hkv, G, D) decode contract, for tests.

On a CUDA tensor the wrapper launches the kernel of
`csrc/paged_attention.cu` or raises; on a CPU tensor it gathers the view
and runs `flash_attention.ops.attend_partial_plain` on it.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels.build import (COUNT_LOCK, CSRC, KernelLibrary,
                                      cuda_stream, refuse_grad)
from repro_torch.kernels.flash_attention import ops as fa

#: kernel launches made by `paged_attend_partial` (a plain integer; reset
#: it to 0 before a run whose launches should be counted)
LAUNCHES = 0
#: the launches of them that read an int8 pool (the int8 form)
LAUNCHES_INT8_KV = 0
#: the launches of them in the latent form (Dk != Dv: MLA's latent pools)
LAUNCHES_LATENT = 0
#: the launches of them in the many-row form (f32 / bf16 K/V, R >= R_MMA)
LAUNCHES_MANY_ROWS = 0
#: the launches of them by head widths (Dk, Dv) (clear it before a run
#: whose launches should be counted)
LAUNCHES_BY_PAIR = {}


def _declare(lib):
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    fn = lib.paged_partial_launch
    fn.argtypes = ([vp] * 11            # q k v q_pos page_pos table
                                        # k_scale v_scale acc m l
                   + [i32] * 8          # B T G H n_view page_size
                                        # Dk Dv
                   + [i64] * 19         # strides
                   + [ctypes.c_float]   # scale
                   + [i32] * 7          # window q_bf16 kv
                                        # n_split span_tiles v_in_k
                                        # row_tile
                   + [vp])              # stream
    fn.restype = ctypes.c_int
    fa.declare_smem(lib.paged_smem)


#: the kernel's source and built library (`csrc/paged_attention.cu`)
LIBRARY = KernelLibrary(
    "paged_attention",
    Path(__file__).resolve().parent / "csrc" / "paged_attention.cu",
    headers=[CSRC / "attention_partial.cuh", CSRC / "smem_report.cuh"],
    declare=_declare)


# =====================================================================
# plain version
# =====================================================================

def gather_view(pages, page_view):
    """The view's pages in logical order: (P, ps, ...) -> (B, n_view * ps,
    ...) — the resident layout of the keys a request holds."""
    B, nv = page_view.shape
    g = pages[page_view.long()]                      # (B, nv, ps, ...)
    return g.reshape((B, nv * pages.shape[1]) + pages.shape[2:])


def paged_attend_partial_plain(q, k, v, q_pos, page_pos, page_view, *,
                               scale, window=0, block=None, k_scale=None,
                               v_scale=None):
    """Plain PyTorch partials, same arguments and results as
    `paged_attend_partial`: the gathered view (an int8 pool's with its
    scales) through `attend_partial_plain` (`block` is its tile)."""
    scales = {}
    if k_scale is not None:
        scales = dict(k_scale=gather_view(k_scale, page_view),
                      v_scale=gather_view(v_scale, page_view))
    return fa.attend_partial_plain(
        q, gather_view(k, page_view), gather_view(v, page_view), q_pos,
        gather_view(page_pos, page_view), scale=scale, causal=True,
        window=window, block=block, **scales)


# =====================================================================
# kernel wrapper
# =====================================================================

def _check(cond, msg):
    """Raise on a failed check; `msg` is a string or a callable that
    builds it."""
    if not cond:
        raise ValueError(f"paged-attention kernel: "
                         f"{msg() if callable(msg) else msg}")


_FN = None


def _launch(q, k, v, q_pos, page_pos, page_view, *, scale, window,
            k_scale=None, v_scale=None):
    B, T, Hkv, G, Dk = q.shape
    P, ps = page_pos.shape
    Dv = v.shape[-1]
    dev = q.device
    refuse_grad("paged-attention kernel", "a page-pool read has no "
                "gradient (training runs without a cache)", q, k, v,
                k_scale, v_scale)
    # (messages are built only when a check fails: this runs per call)
    fa.check_pair(_check, Dk, Dv, k.dtype)
    _check(q.dtype in fa._KV_DTYPES, lambda: (
        f"dtype q={q.dtype}; supported float32 / bfloat16"))
    _check(k.shape == (P, ps, Hkv, Dk) and v.shape == (P, ps, Hkv, Dv),
           "k/v page shapes")
    kv, sc = fa.check_kv(_check, k, v, k_scale, v_scale, (P, ps), Hkv, dev)
    _check(ps > 0 and ps & (ps - 1) == 0,
           lambda: f"page size {ps} is not a power of two")
    qs, ks, vs = q.stride(), k.stride(), v.stride()
    _check(qs[4] == 1 and ks[3] == 1 and vs[3] == 1,
           "q, k and v need a contiguous last (head) dimension")
    _check(fa.kv_aligned(k, ks) and fa.kv_aligned(v, vs), "k and v need "
           "16-byte aligned rows, base and strides (int8 rows of D 120: "
           "8-byte)")
    for name, t in (("k", k), ("v", v), ("q_pos", q_pos),
                    ("page_pos", page_pos), ("page_view", page_view)):
        _check(t.device == dev, lambda: f"{name} is on {t.device}, q on "
               f"{dev}")
    _check(q_pos.shape == (B, T), "q_pos must be (B, T)")
    _check(page_view.dim() == 2 and page_view.shape[0] == B,
           "page_view must be (B, n_view)")
    nv = page_view.shape[1]
    q_pos = fa.as_int32(q_pos)
    page_pos = fa.as_int32(page_pos)
    page_view = fa.as_int32(page_view)

    m, l, acc = fa.empty_partials((B, T, Hkv, G), Dv, dev)
    if B * T * G == 0 or nv == 0:
        return m.fill_(fa.NEG_INF), l.zero_(), acc.zero_()
    if Dk != Dv and not fa.rows_aligned(q):
        q = q.clone(memory_format=torch.contiguous_format)
        qs = q.stride()

    global _FN, LAUNCHES, LAUNCHES_INT8_KV, LAUNCHES_LATENT
    global LAUNCHES_MANY_ROWS
    if _FN is None:
        _FN = LIBRARY.load().paged_partial_launch
    # the form and split of kernel 1 on the gathered view (S = n_view *
    # ps), so both kernels sum the same tiles in the same order
    int8 = kv == fa.KV_KIND[torch.int8]
    n_split, span, rows, many = fa.launch_plan(B, Hkv, T, G, nv * ps, Dk,
                                               Dv, k.dtype)
    rc = _FN(q.data_ptr(), k.data_ptr(), v.data_ptr(), q_pos.data_ptr(),
            page_pos.data_ptr(), page_view.data_ptr(),
            0 if k_scale is None else k_scale.data_ptr(),
            0 if v_scale is None else v_scale.data_ptr(), acc.data_ptr(),
            m.data_ptr(), l.data_ptr(),
            B, T, G, Hkv, nv, ps, Dk, Dv,
            qs[0], qs[1], qs[2], qs[3], ks[0], ks[1], ks[2],
            vs[0], vs[1], vs[2], *sc, page_pos.stride(0), q_pos.stride(0),
            page_view.stride(0), float(scale), int(window),
            int(q.dtype == torch.bfloat16), kv, n_split, span,
            int(fa.v_in_k(k, v)), rows, cuda_stream(dev))
    if rc != 0:
        raise RuntimeError(f"paged-attention kernel launch failed: CUDA "
                           f"error {rc}")
    with COUNT_LOCK:
        LAUNCHES += 1
        if int8:
            LAUNCHES_INT8_KV += 1
        if Dk != Dv:
            LAUNCHES_LATENT += 1
        if many:
            LAUNCHES_MANY_ROWS += 1
        LAUNCHES_BY_PAIR[Dk, Dv] = LAUNCHES_BY_PAIR.get((Dk, Dv), 0) + 1
    return m, l, acc


def paged_attend_partial(q, k, v, q_pos, page_pos, page_view, *, scale,
                         window=0, block=None, k_scale=None, v_scale=None):
    """Causal online-softmax partials (m, l, acc) over a page pool read
    through `page_view`; see the module docstring.

    CUDA tensors launch the Hopper kernel (or raise on what it does not
    take; an int8 pool goes to its int8 form); CPU tensors run
    `paged_attend_partial_plain`, whose tile is `block` (the kernel tiles
    keys itself)."""
    if q.device.type == "cuda":
        return _launch(q, k, v, q_pos, page_pos, page_view, scale=scale,
                       window=window, k_scale=k_scale, v_scale=v_scale)
    if q.device.type != "cpu":
        raise ValueError(f"paged-attention: unsupported device {q.device}")
    return paged_attend_partial_plain(q, k, v, q_pos, page_pos, page_view,
                                      scale=scale, window=window,
                                      block=block, k_scale=k_scale,
                                      v_scale=v_scale)


def paged_flash_decode(q, k_pages, v_pages, page_pos, q_pos, block_tables,
                       *, scale, window=0):
    """The Pallas kernel's decode contract: q (B, Hkv, G, Dk); k_pages /
    v_pages (P, Hkv, ps, Dk/Dv); page_pos (P, ps); q_pos (B,);
    block_tables (B, n_view). Returns acc (B, Hkv, G, Dv), m (B, Hkv, G),
    l (B, Hkv, G), all f32."""
    m, l, acc = paged_attend_partial(
        q[:, None], k_pages.permute(0, 2, 1, 3), v_pages.permute(0, 2, 1, 3),
        q_pos[:, None], page_pos, block_tables, scale=scale, window=window)
    return acc[:, 0], m[:, 0], l[:, 0]
