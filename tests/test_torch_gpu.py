"""Tests of the PyTorch port that need an NVIDIA GPU (marked `gpu`).

The CUDA kernels have no CPU mode, so these skip on a host without a card.
This file imports neither JAX nor the JAX package, so it also runs where
only PyTorch is installed; there, run it without the repository's
conftest (which imports the JAX package):

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_gpu.py
"""
import ctypes
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.config import CoSineConfig, ModelConfig, SSMConfig
from repro_torch.configs.drafters import int8_variant
from repro_torch.kernels.build import SMEM_LIMIT
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.kernels.int8_gemv import ops as ig
from repro_torch.kernels.paged_attention import ops as pa
from repro_torch.kernels.ssd_scan import ops as ssd
from repro_torch.models import model as M
from repro_torch.models import quantize
from repro_torch.serving.engine import SpeculativeEngine


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D,G,T", [(64, 7, 1), (128, 1, 10), (32, 2, 40),
                                   (16, 4, 3), (128, 4, 6), (120, 4, 1),
                                   (120, 4, 10), (120, 4, 6)])
def test_cuda_kernel_matches_plain(cuda, D, G, T, dtype):
    """The Hopper kernel against its plain version: a slot pool read in
    place (with a repeated scratch row), plain causal, a mask, a window
    and a fully masked row; 300 keys, which the split plan cuts into 5
    spans of a cluster of 8 (the last one short). Head width 120
    (h2o-danube3) is served by 15-value strips of 1-value chunks. Same
    f32 arithmetic in another summation order, so rtol = atol = 1e-4."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    B, H, P, C = 3, 2, 5, 300
    q = torch.randn((B, T, H, G, D), generator=gen, device=cuda)
    k = torch.randn((P, C, H, D), generator=gen, device=cuda).to(dtype)
    v = torch.randn((P, C, H, D), generator=gen, device=cuda).to(dtype)
    kpos = torch.arange(C, dtype=torch.int32, device=cuda).repeat(P, 1)
    kpos[:, 250:] = -1
    kpos[2] = -1                                   # an empty slot
    qpos = (240 + torch.arange(T, dtype=torch.int32, device=cuda)).repeat(B, 1)
    slot_idx = torch.tensor([4, 0, 2], dtype=torch.int32, device=cuda)
    mask = torch.rand((B, T, C), generator=gen, device=cuda) < 0.7
    for kw in (dict(), dict(mask=mask), dict(window=50),
               dict(causal=False)):
        got = fa.attend_partial(q, k, v, qpos, kpos, scale=D ** -0.5,
                                slot_idx=slot_idx, **kw)
        want = fa.attend_partial_plain(q, k, v, qpos, kpos, scale=D ** -0.5,
                                       slot_idx=slot_idx, **kw)
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
        assert float(got[1][2].abs().max()) == 0.0   # empty slot: l = 0


@pytest.mark.gpu
@pytest.mark.parametrize("xdtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M_", [1, 4, 5, 8, 9, 24, 64, 512])
@pytest.mark.parametrize("K,N", [(896, 128), (100, 4864), (37, 13)])
def test_int8_gemv_matches_plain(cuda, M_, K, N, xdtype):
    """The int8 GEMV kernel against its plain version, for the dense
    (K, N) layout and the transposed (N, K) table, aligned and not, on
    every path (split-K, rows, wgmma from TC_MIN_ROWS = 5 bf16 rows). The
    same f32 products summed in another order: rtol = atol = 1e-4 on
    outputs of O(1)."""
    gen = torch.Generator(device=cuda).manual_seed(M_ * K)
    w = torch.randn((K, N), generator=gen, device=cuda) / K ** 0.5
    q = quantize.quantize_weight(w)
    x = torch.randn((M_, K), generator=gen, device=cuda).to(xdtype)
    want = ig.int8_gemv_plain(x, q["w8"], q["scale"])
    got = ig._launch(x, q["w8"], q["scale"])
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    table = q["w8"].t().contiguous()               # (N, K), as (V, D)
    got_t = ig._launch(x, table.t(), q["scale"].reshape(N, 1))
    torch.testing.assert_close(got_t, want, rtol=1e-4, atol=1e-4)
    # the public wrapper the model calls: the kernel's f32 output cast
    # once to x's dtype, bit for bit, for both layouts
    for w8, sc, y32 in ((q["w8"], q["scale"], got),
                        (table.t(), q["scale"].reshape(N, 1), got_t)):
        out = ig.int8_gemv(x, w8, sc)
        assert out.dtype == xdtype
        assert torch.equal(out, y32.to(xdtype))


@pytest.mark.gpu
@pytest.mark.parametrize("rows_layout", [False, True])
@pytest.mark.parametrize("M_,K,N,wide", [
    (77, 144, 208, 0), (77, 144, 200, 224), (130, 37, 13, 0),
    (9, 100, 4864, 0), (200, 4864, 96, 0)])
def test_int8_tensor_core_path_ragged(cuda, M_, K, N, wide, rows_layout):
    """The wgmma path at ragged M, N and K: 16-byte aligned rows with a
    partial last k tile and column tile (cp.async zero-fill), a column
    slice of a wider weight (a partial 16-byte chunk), unaligned strides
    (byte loads), and a long K. rtol = atol = 1e-4."""
    gen = torch.Generator(device=cuda).manual_seed(M_ + K + N)
    w = torch.randn((K, wide or N), generator=gen, device=cuda) / K ** 0.5
    q = quantize.quantize_weight(w)
    w8, sc = q["w8"][:, :N], q["scale"][:, :N].contiguous()
    if rows_layout:
        w8 = q["w8"].t().contiguous()[:N].t()
    x = torch.randn((M_, K), generator=gen, device=cuda).to(torch.bfloat16)
    assert ig.plan(M_, K, N, rows_layout, True).path == "tc"
    got = ig._launch(x, w8, sc)
    torch.testing.assert_close(got, ig.int8_gemv_plain(x, w8, sc),
                               rtol=1e-4, atol=1e-4)


def _int8_case(cuda, path):
    """x, w8 and scale for one call of each kernel path: split-K in a
    cluster of 16, the transposed table, wgmma."""
    gen = torch.Generator(device=cuda).manual_seed(7)
    M_, K, N = {"splitk": (4, 896, 128), "rows": (4, 896, 4096),
                "tc": (64, 896, 896)}[path]
    w = torch.randn((K, N), generator=gen, device=cuda) / K ** 0.5
    q = quantize.quantize_weight(w)
    w8, sc = q["w8"], q["scale"]
    if path == "rows":
        w8 = w8.t().contiguous().t()
    x = torch.randn((M_, K), generator=gen, device=cuda).to(torch.bfloat16)
    assert ig.plan(M_, K, N, path == "rows", True).path == path
    return x, w8, sc


@pytest.mark.gpu
@pytest.mark.parametrize("path", ["splitk", "rows", "tc"])
def test_int8_same_bits_in_graph_on_stream_and_twice(cuda, path):
    """One launch per call, and the same output bits from the default
    stream, a second run, a second stream and a CUDA graph replay (no
    atomics, sums in a fixed order, no state kept between calls)."""
    x, w8, sc = _int8_case(cuda, path)
    before = ig.LAUNCHES
    ref = ig._launch(x, w8, sc)
    assert ig.LAUNCHES == before + 1
    assert torch.equal(ig._launch(x, w8, sc), ref)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        on_side = ig._launch(x, w8, sc)
    torch.cuda.current_stream().wait_stream(side)
    assert torch.equal(on_side, ref)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        captured = ig._launch(x, w8, sc)
    g.replay()
    torch.cuda.synchronize()
    assert torch.equal(captured, ref)


def _smem(fn, *args):
    """(dynamic, static, limit) bytes from a library's shared-memory
    report of one compiled kernel."""
    out = [ctypes.c_int() for _ in range(3)]
    rc = fn(*args, *(ctypes.byref(o) for o in out))
    assert rc == 0, f"CUDA error {rc}"
    return tuple(o.value for o in out)


@pytest.mark.gpu
def test_int8_smem_matches_compiled_kernels(cuda):
    """Every instantiation of the three paths asks for the dynamic shared
    memory `plan_smem` counts, and that with the static shared memory of
    the compiled kernel fits the device's limit per block, SMEM_LIMIT
    (the rows kernel at the largest K its plan takes)."""
    lib = ig.LIBRARY.load()
    cases = [(ig.Plan("tc", bn=bn), 2, bn, rows, 896)
             for bn in (64, 128) for rows in (0, 1)]
    for x_bf16 in (0, 1):
        for mb in (1, 2, 4, 8):
            cases.append((ig.Plan("splitk", mb=mb), 0, mb, x_bf16, 896))
            cases.append((ig.Plan("rows", mb=mb), 1, mb, x_bf16,
                          ig.ROWS_SMEM_MAX // (4 * mb)))
    for p, path, param, variant, K in cases:
        dynamic, static, limit = _smem(lib.int8_smem, path, param, variant,
                                       K)
        assert limit == SMEM_LIMIT
        assert dynamic == ig.plan_smem(p, K), (p, dynamic)
        assert dynamic + static <= limit, (p, dynamic, static)


@pytest.mark.gpu
def test_attention_smem_matches_compiled_kernels(cuda):
    """Both attention kernels, at every head-width pair (the latent form
    (Dk != Dv) included), query dtype and K/V storage (f32, bf16 and, for
    Dk == Dv, the int8 form, D 120 too) and, for f32 / bf16 K/V at Dk ==
    Dv, either row tile (16: the GQA form; 64: the many-row form, at D 64,
    120 and 128 only), ask for the dynamic shared memory `kernel_smem`
    counts, and that with the static shared memory of the compiled kernel
    fits SMEM_LIMIT, the device's limit per block."""
    for f in (fa.LIBRARY.load().fa_smem, pa.LIBRARY.load().paged_smem):
        for Dk, Dv in fa.SUPPORTED_PAIRS:
            for q_bf16 in (0, 1):
                for kv_dtype, kv in fa.KV_KIND.items():
                    if kv_dtype == torch.int8 and Dk != Dv:
                        # no int8 form: the latent pairs
                        out = [ctypes.c_int() for _ in range(3)]
                        assert f(Dk, Dv, q_bf16, kv, 16,
                                 *(ctypes.byref(o) for o in out)) != 0
                        continue
                    size = torch.empty((), dtype=kv_dtype).element_size()
                    tiles = ((16, 64) if Dk == Dv and size > 1
                             else (fa.tiling(Dk != Dv, size == 1)[2],))
                    for rows in tiles:
                        many = Dk == Dv and size > 1 and rows == 64
                        if many and Dk not in fa.MMA_HEADS:
                            out = [ctypes.c_int() for _ in range(3)]
                            assert f(Dk, Dv, q_bf16, kv, rows,
                                     *(ctypes.byref(o) for o in out)) != 0
                            continue
                        dynamic, static, limit = _smem(f, Dk, Dv, q_bf16,
                                                       kv, rows)
                        case = (f.__name__, Dk, Dv, q_bf16, kv, rows,
                                dynamic, static)
                        assert limit == SMEM_LIMIT
                        assert dynamic == fa.kernel_smem(
                            Dk, Dv, size, 2 if q_bf16 else 4, many), case
                        assert dynamic + static <= limit, case


@pytest.mark.gpu
def test_attention_kernels_refuse_unaligned_kv(cuda):
    """K/V tiles are copied in 16-byte pieces, so both attention wrappers
    raise ValueError, and launch nothing, on K/V whose base or key stride
    is not a 16-byte multiple."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    B, T, H, G, D, S, ps = 2, 1, 2, 4, 64, 64, 16
    q = torch.randn((B, T, H, G, D), generator=gen, device=cuda)
    qpos = torch.full((B, T), S - 1, dtype=torch.int32, device=cuda)
    kpos = torch.arange(S, dtype=torch.int32, device=cuda).repeat(B, 1)

    def kv(shape):
        n = int(np.prod(shape))
        flat = torch.randn(n + 1, generator=gen, device=cuda)
        good = flat[:n].view(shape).to(torch.bfloat16)
        off_base = flat.to(torch.bfloat16)[1:].view(shape)   # base + 2 B
        wide = torch.randn((*shape[:-1], D + 1), generator=gen,
                           device=cuda).to(torch.bfloat16)[..., :D]
        return good, (off_base, wide)

    v, bad = kv((B, S, H, D))
    before = fa.LAUNCHES
    for k in bad:
        with pytest.raises(ValueError, match="16-byte"):
            fa.attend_partial(q, k, v, qpos, kpos, scale=D ** -0.5)
        with pytest.raises(ValueError, match="16-byte"):
            fa.attend_partial(q, v, k, qpos, kpos, scale=D ** -0.5)
    assert fa.LAUNCHES == before

    P = 2 + B * S // ps
    vp, bad = kv((P, ps, H, D))
    pos = torch.full((P, ps), -1, dtype=torch.int32, device=cuda)
    pos[2:] = torch.arange(S, dtype=torch.int32, device=cuda).view(
        -1, ps).repeat(B, 1)
    tbl = torch.arange(2, P, dtype=torch.int32, device=cuda).view(B, -1)
    before = pa.LAUNCHES
    for kp in bad:
        with pytest.raises(ValueError, match="16-byte"):
            pa.paged_attend_partial(q, kp, vp, qpos, pos, tbl,
                                    scale=D ** -0.5)
        with pytest.raises(ValueError, match="16-byte"):
            pa.paged_attend_partial(q, vp, kp, qpos, pos, tbl,
                                    scale=D ** -0.5)
    assert pa.LAUNCHES == before
    # the aligned views launch once each
    fa_before, pa_before = fa.LAUNCHES, pa.LAUNCHES
    fa.attend_partial(q, v, v, qpos, kpos, scale=D ** -0.5)
    pa.paged_attend_partial(q, vp, vp, qpos, pos, tbl, scale=D ** -0.5)
    assert (fa.LAUNCHES, pa.LAUNCHES) == (fa_before + 1, pa_before + 1)


@pytest.mark.gpu
def test_d120_smem_is_the_double_buffered_tiles(cuda):
    """At head width 120 a block stages two 32-key K and V tiles of 480
    bytes a row (f32): 2 x 2 x 32 x 120 x 4 = 61,440 bytes, half that at
    bf16, as the compiled kernels ask."""
    for f in (fa.LIBRARY.load().fa_smem, pa.LIBRARY.load().paged_smem):
        for kv, size in ((0, 4), (1, 2)):
            dynamic, static, limit = _smem(f, 120, 120, 0, kv, 16)
            assert dynamic == 2 * 2 * 32 * 120 * size == fa.kernel_smem(
                120, 120, size)
            assert dynamic + static <= limit


def _scrambled_pages(gen, cuda, ps, lens, make):
    """A page pool holding `lens` keys of each request on scrambled pages
    (NULL filler past them): (pool leaves from `make(P)`, positions,
    block table of 16 entries)."""
    B, nv = len(lens), 16
    P = 2 + sum(-(-n // ps) for n in lens) + 3
    leaves = make(P)
    pos = torch.full((P, ps), -1, dtype=torch.int32, device=cuda)
    tbl = torch.ones((B, nv), dtype=torch.int32, device=cuda)
    free = (torch.randperm(P - 2, generator=torch.Generator().manual_seed(
        ps + sum(lens))) + 2).tolist()
    for b, n in enumerate(lens):
        for j in range(-(-n // ps)):
            page = free.pop()
            cnt = min(ps, n - j * ps)
            pos[page, :cnt] = j * ps + torch.arange(cnt, dtype=torch.int32,
                                                    device=cuda)
            tbl[b, j] = page
    return leaves, pos, tbl


@pytest.mark.gpu
@pytest.mark.parametrize("qdtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T", [1, 10, 6, 512])
def test_int8_kv_at_d120_matches_plain_and_paged_is_kernel1(cuda, T,
                                                            qdtype):
    """The int8 K/V form at head width 120 (h2o-danube3-4b's int8 caches,
    Hkv 8 of G 4 as phase M-int8 reads them): 120-byte rows, 8-byte
    aligned only, staged by 8-byte copies, and a bf16 view padded with
    zero columns to 128, at decode, the tree's cache pass, a commit and a
    512-token prefill (16- and 64-row blocks). Kernel 1 against its plain
    version on a slot pool (plain causal, a mask, a window, non-causal,
    an empty slot: l = 0): the same bf16 values, products split into
    bf16 halves, so rtol = atol = 1e-4; the paged kernel against its
    plain version and bit for bit kernel 1's int8 form on the gathered
    view (pages scrambled, a window)."""
    gen = torch.Generator(device=cuda).manual_seed(120 + T)
    B, H, G, D, P, C = 3, 8, 4, 120, 5, 600
    q = torch.randn((B, T, H, G, D), generator=gen, device=cuda).to(qdtype)
    k8, ks = _int8_kv(gen, (P, C, H, D), cuda)
    v8, vs = _int8_kv(gen, (P, C, H, D), cuda)
    assert k8.stride(2) * k8.element_size() % 16 == 8   # odd heads: 8 B
    kpos = torch.arange(C, dtype=torch.int32, device=cuda).repeat(P, 1)
    kpos[:, 560:] = -1
    kpos[2] = -1                                   # an empty slot
    qpos = (548 - T + torch.arange(T, dtype=torch.int32,
                                   device=cuda)).repeat(B, 1)
    slot_idx = torch.tensor([4, 0, 2], dtype=torch.int32, device=cuda)
    mask = torch.rand((B, T, C), generator=gen, device=cuda) < 0.7
    sc = dict(k_scale=ks, v_scale=vs, slot_idx=slot_idx, scale=D ** -0.5)
    for kw in (dict(), dict(mask=mask), dict(window=50),
               dict(causal=False)):
        before = (fa.LAUNCHES_INT8_KV, fa.LAUNCHES_MANY_ROWS)
        got = fa.attend_partial(q, k8, v8, qpos, kpos, **sc, **kw)
        assert (fa.LAUNCHES_INT8_KV, fa.LAUNCHES_MANY_ROWS) == (
            before[0] + 1, before[1])
        want = fa.attend_partial_plain(q, k8, v8, qpos, kpos, **sc, **kw)
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
        assert float(got[1][2].abs().max()) == 0.0   # empty slot: l = 0

    ps = 64
    lens = [5 * ps + 3 + T, ps + T, 7 + T]

    def make(n):
        return (_int8_kv(gen, (n, ps, H, D), cuda),
                _int8_kv(gen, (n, ps, H, D), cuda))

    ((pk8, pks), (pv8, pvs)), pos, tbl = _scrambled_pages(gen, cuda, ps,
                                                         lens, make)
    qp = torch.tensor([[n - T + t for t in range(T)] for n in lens],
                      dtype=torch.int32, device=cuda)
    for window in (0, 50):
        kw = dict(scale=D ** -0.5, window=window)
        got = pa.paged_attend_partial(q, pk8, pv8, qp, pos, tbl,
                                      k_scale=pks, v_scale=pvs, **kw)
        want = pa.paged_attend_partial_plain(q, pk8, pv8, qp, pos, tbl,
                                             k_scale=pks, v_scale=pvs, **kw)
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
        g = pa.gather_view
        k1 = fa.attend_partial(q, g(pk8, tbl), g(pv8, tbl), qp, g(pos, tbl),
                               k_scale=g(pks, tbl), v_scale=g(pvs, tbl), **kw)
        for a, b in zip(got, k1):
            assert torch.equal(a, b)


def _many_row_tokens(D, kvdtype):
    """(T, G) of launches just below R_MMA (the GQA form), at it and far
    above it (the many-row form) for f32 / bf16 K/V of width D."""
    return [(fa.R_MMA - 1, 1), (fa.R_MMA, 1), (128, 4)]


@pytest.mark.gpu
@pytest.mark.parametrize("qdtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kvdtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [64, 120, 128])
def test_many_row_form_matches_plain(cuda, D, kvdtype, qdtype):
    """The many-row form (64 rows a block on tensor cores) against the
    plain version, from a slot pool read in place (a repeated slot, an
    empty one: l = 0), under the causal mask, a tree-like bool mask, a
    window and no causal mask, at R just below R_MMA (the GQA form, no
    many-row launch), at R_MMA and at 512 rows (G 4), the masked read on
    the GQA form (as a tree segment) at every R: f32 K/V by 3xTF32
    (about 2^-19 a product), bf16 K/V exact with q and P in two bf16
    halves (about 2^-17), summed in f32 in another order: rtol = atol =
    1e-4. Two runs give the same bits."""
    gen = torch.Generator(device=cuda).manual_seed(D)
    B, H, P, C = 3, 2, 5, 700
    k = torch.randn((P, C, H, D), generator=gen, device=cuda).to(kvdtype)
    v = torch.randn((P, C, H, D), generator=gen, device=cuda).to(kvdtype)
    kpos = torch.arange(C, dtype=torch.int32, device=cuda).repeat(P, 1)
    kpos[:, 650:] = -1
    kpos[2] = -1                                   # an empty slot
    slot_idx = torch.tensor([4, 2, 4], dtype=torch.int32, device=cuda)
    size = k.element_size()
    for T, G in _many_row_tokens(D, kvdtype):
        many = fa.many_rows(D, size, T * G)
        assert many == (T * G >= fa.R_MMA)
        q = torch.randn((B, T, H, G, D), generator=gen,
                        device=cuda).to(qdtype)
        qpos = (640 - T + torch.arange(T, dtype=torch.int32,
                                       device=cuda)).repeat(B, 1)
        mask = torch.rand((B, T, C), generator=gen, device=cuda) < 0.7
        for kw in (dict(), dict(mask=mask), dict(window=50),
                   dict(causal=False)):
            kw.update(scale=D ** -0.5, slot_idx=slot_idx)
            before = fa.LAUNCHES_MANY_ROWS
            got = fa.attend_partial(q, k, v, qpos, kpos, **kw)
            assert fa.LAUNCHES_MANY_ROWS == before + (many and
                                                      "mask" not in kw)
            want = fa.attend_partial_plain(q, k, v, qpos, kpos, **kw)
            for a, b in zip(got, want):
                torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
            assert float(got[1][1].abs().max()) == 0.0   # empty slot
            for a, b in zip(got, fa.attend_partial(q, k, v, qpos, kpos,
                                                   **kw)):
                assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("kvdtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [64, 120, 128])
def test_many_row_form_paged_bitwise_kernel1(cuda, D, kvdtype):
    """The paged kernel's many-row form against its plain version (1e-4)
    and bit for bit kernel 1 on the gathered view, at R_MMA and at 512
    rows: both wrappers take the form and split from the same (R, D,
    dtype), and 64-key pages in scrambled order, NULL filler and a window
    change nothing."""
    gen = torch.Generator(device=cuda).manual_seed(D + 1)
    B, H, ps = 3, 2, 64
    for T, G in _many_row_tokens(D, kvdtype)[1:]:
        lens = [5 * ps + 3 + T, ps + T, 7 + T]

        def make(n):
            return tuple(torch.randn((n, ps, H, D), generator=gen,
                                     device=cuda).to(kvdtype)
                         for _ in range(2))

        (k, v), pos, tbl = _scrambled_pages(gen, cuda, ps, lens, make)
        q = torch.randn((B, T, H, G, D), generator=gen, device=cuda)
        qp = torch.tensor([[n - T + t for t in range(T)] for n in lens],
                          dtype=torch.int32, device=cuda)
        for window in (0, 50):
            kw = dict(scale=D ** -0.5, window=window)
            before = pa.LAUNCHES_MANY_ROWS
            got = pa.paged_attend_partial(q, k, v, qp, pos, tbl, **kw)
            assert pa.LAUNCHES_MANY_ROWS == before + 1
            want = pa.paged_attend_partial_plain(q, k, v, qp, pos, tbl, **kw)
            for a, b in zip(got, want):
                torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
            g = pa.gather_view
            k1 = fa.attend_partial(q, g(k, tbl), g(v, tbl), qp, g(pos, tbl),
                                   **kw)
            for a, b in zip(got, k1):
                assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["vision_cross", "whisper_cross",
                                  "whisper_encoder"])
def test_noncausal_reads_match_plain(cuda, case, dtype):
    """Kernel 1's non-causal form at the served shapes: a cross read of
    one token over 1601 image rows (Hkv 8, G 4, D 128) and over 1500
    audio rows (Hkv 12, G 1, D 64), each of a slot pool through slot_idx
    (one slot empty: l = 0), and the Whisper encoder's bidirectional
    self-attention, T = S = 1500 with no pool. Neither 1601 nor 1500 is a
    whole number of 32-key tiles. rtol = atol = 1e-4 against plain."""
    gen = torch.Generator(device=cuda).manual_seed(len(case))
    H, G, D, S = {"vision_cross": (8, 4, 128, 1601),
                  "whisper_cross": (12, 1, 64, 1500),
                  "whisper_encoder": (12, 1, 64, 1500)}[case]
    if case == "whisper_encoder":
        B, T, P, slot_idx = 1, S, 1, None
    else:
        B, T, P = 3, 1, 5
        slot_idx = torch.tensor([4, 2, 1], dtype=torch.int32, device=cuda)
    q = torch.randn((B, T, H, G, D), generator=gen, device=cuda)
    k = torch.randn((P, S, H, D), generator=gen, device=cuda).to(dtype)
    v = torch.randn((P, S, H, D), generator=gen, device=cuda).to(dtype)
    kpos = torch.arange(S, dtype=torch.int32, device=cuda).repeat(P, 1)
    if slot_idx is not None:
        kpos[2] = -1                          # a slot with no frontend
    qpos = torch.zeros((B, T), dtype=torch.int32, device=cuda)
    kw = dict(scale=D ** -0.5, causal=False, slot_idx=slot_idx)
    got = fa.attend_partial(q, k, v, qpos, kpos, **kw)
    want = fa.attend_partial_plain(q, k, v, qpos, kpos, **kw)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
    if slot_idx is not None:
        assert float(got[1][1].abs().max()) == 0.0
        assert float(fa.finalize(got)[1].abs().max()) == 0.0


def _split_case(cuda, case, dtype):
    """Kernel 1 inputs at the split's edges (see the test below)."""
    gen = torch.Generator(device=cuda).manual_seed(11)
    B, T, H, G, D, P = 4, 1, 2, 7, 64, 6
    S = 1024 if case == "sixteen_splits" else 300
    q = torch.randn((B, T, H, G, D), generator=gen, device=cuda)
    k = torch.randn((P, S, H, D), generator=gen, device=cuda).to(dtype)
    v = torch.randn((P, S, H, D), generator=gen, device=cuda).to(dtype)
    lens = [250, 37, 0, 290]                      # slot 3 holds no key
    kpos = torch.full((P, S), -1, dtype=torch.int32, device=cuda)
    for slot, n in zip((1, 2, 3, 4), lens):
        kpos[slot, :n] = torch.arange(n, dtype=torch.int32, device=cuda)
    slot_idx = torch.tensor([1, 2, 3, 4], dtype=torch.int32, device=cuda)
    qpos = torch.tensor([[max(n - 1, 0)] for n in lens], dtype=torch.int32,
                        device=cuda)
    kw = dict(scale=D ** -0.5, slot_idx=slot_idx)
    if case == "window":
        kw["window"] = 40                 # empties all splits but one
    if case == "tree_mask":
        kw["mask"] = torch.rand((B, T, S), generator=gen, device=cuda) < 0.5
    return (q, k, v, qpos, kpos), kw


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["ragged", "window", "tree_mask",
                                  "sixteen_splits"])
def test_kernel1_split_edges_match_plain_and_repeat(cuda, case, dtype):
    """Kernel 1 where the split-K plan cuts: S = 300 (10 tiles over 8
    splits: trailing splits empty), a request with no keys (l = 0), a
    window that empties whole splits, a tree mask, and 16 splits over
    S = 1024 (a non-portable cluster). Within 1e-4 of the plain version,
    and the same bits on a second run."""
    args, kw = _split_case(cuda, case, dtype)
    B, T, H, G, _ = args[0].shape
    n, _ = fa.plan_splits(B, H, T * G, args[1].shape[1])
    assert n == (16 if case == "sixteen_splits" else 8)
    got = fa.attend_partial(*args, **kw)
    want = fa.attend_partial_plain(*args, **kw)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
    assert float(got[1][2].abs().max()) == 0.0      # no keys: l = 0
    again = fa.attend_partial(*args, **kw)
    for a, b in zip(got, again):
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int8])
@pytest.mark.parametrize("T,G,H", [(1, 7, 2), (10, 1, 20), (6, 4, 8)])
def test_kernel1_bits_do_not_depend_on_capacity(cuda, T, G, H, dtype):
    """A slot pool of 1024 keys and a 128-key copy of the same keys give
    kernel 1 the same bits: the span of the key split comes from the
    grid, and blocks past the live keys merge in as exact no-ops. The
    paged pool's streams equal the resident pool's by this (phase C).
    int8: the int8 K/V form, with its scales cut the same way."""
    gen = torch.Generator(device=cuda).manual_seed(T * G)
    B, D, S = 4, 64, 1024
    q = torch.randn((B, T, H, G, D), generator=gen, device=cuda)
    int8 = dtype == torch.int8
    if int8:
        k, ks = _int8_kv(gen, (B, S, H, D), cuda)
        v, vs = _int8_kv(gen, (B, S, H, D), cuda)
    else:
        k = torch.randn((B, S, H, D), generator=gen, device=cuda).to(dtype)
        v = torch.randn((B, S, H, D), generator=gen, device=cuda).to(dtype)
    lens = [100, 128 - T, 1, 60]
    kpos = torch.full((B, S), -1, dtype=torch.int32, device=cuda)
    for b, n in enumerate(lens):
        kpos[b, :n + T] = torch.arange(n + T, dtype=torch.int32, device=cuda)
    qpos = torch.tensor([[n + t for t in range(T)] for n in lens],
                        dtype=torch.int32, device=cuda)
    full = fa.attend_partial(q, k, v, qpos, kpos, scale=D ** -0.5,
                             **(dict(k_scale=ks, v_scale=vs) if int8
                                else {}))
    short = fa.attend_partial(
        q, k[:, :128].contiguous(), v[:, :128].contiguous(), qpos,
        kpos[:, :128].contiguous(), scale=D ** -0.5,
        **(dict(k_scale=ks[:, :128].contiguous(),
                v_scale=vs[:, :128].contiguous()) if int8 else {}))
    n_full, span, _, _ = fa.launch_plan(B, H, T, G, S, D, D, dtype)
    n_short, span_short, _, _ = fa.launch_plan(B, H, T, G, 128, D, D, dtype)
    # the same span; more blocks over the long pool (int8: or, with one
    # block, more tiles walked)
    assert span == span_short and n_full >= n_short
    assert n_full > n_short or int8
    for a, b in zip(full, short):
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("ps,nv,T,G", [(16, 3, 1, 7), (16, 64, 1, 7),
                                       (64, 16, 6, 4), (128, 8, 10, 1)])
def test_paged_kernel_bitwise_kernel1_at_split_shapes(cuda, ps, nv, T, G):
    """The paged kernel splits the logical keys as kernel 1 does on the
    gathered view (S = n_view * page_size, 48 keys to 1024), so their
    partials are equal bit for bit, and so are two runs."""
    gen = torch.Generator(device=cuda).manual_seed(ps * nv)
    B, H, D = 4, 2, 64
    S = nv * ps
    lens = [S, S // 2 + 3, 5, 0]
    P = 2 + sum(-(-n // ps) for n in lens) + 2
    k = torch.randn((P, ps, H, D), generator=gen, device=cuda)
    v = torch.randn((P, ps, H, D), generator=gen, device=cuda)
    pos = torch.full((P, ps), -1, dtype=torch.int32, device=cuda)
    tbl = torch.ones((B, nv), dtype=torch.int32, device=cuda)
    free = (torch.randperm(P - 2, generator=torch.Generator().manual_seed(1))
            + 2).tolist()
    for b, n in enumerate(lens):
        for j in range(-(-n // ps)):
            page = free.pop()
            cnt = min(ps, n - j * ps)
            pos[page, :cnt] = j * ps + torch.arange(cnt, dtype=torch.int32,
                                                    device=cuda)
            tbl[b, j] = page
    q = torch.randn((B, T, H, G, D), generator=gen, device=cuda)
    qp = torch.tensor([[max(n - T + t, 0) for t in range(T)] for n in lens],
                      dtype=torch.int32, device=cuda)
    got = pa.paged_attend_partial(q, k, v, qp, pos, tbl, scale=D ** -0.5)
    k1 = fa.attend_partial(q, pa.gather_view(k, tbl), pa.gather_view(v, tbl),
                           qp, pa.gather_view(pos, tbl), scale=D ** -0.5)
    again = pa.paged_attend_partial(q, k, v, qp, pos, tbl, scale=D ** -0.5)
    for a, b, c in zip(got, k1, again):
        assert torch.equal(a, b) and torch.equal(a, c)
    want = pa.paged_attend_partial_plain(q, k, v, qp, pos, tbl,
                                         scale=D ** -0.5)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("ps", [16, 64, 128])
@pytest.mark.parametrize("T,G,D", [(1, 7, 64), (10, 1, 128), (40, 2, 32),
                                   (6, 4, 128), (1, 4, 120), (6, 4, 120)])
def test_paged_kernel_matches_plain_and_kernel1(cuda, ps, T, G, D):
    """The paged kernel against its plain version (rtol = atol = 1e-4),
    and bit for bit against the flash-attention kernel on the gathered
    view; pages in scrambled order, NULL filler entries, a window."""
    gen = torch.Generator(device=cuda).manual_seed(ps + T)
    B, H, nv = 3, 2, 16
    lens = [5 * ps + 3, ps, 7]
    P = 2 + sum(-(-n // ps) for n in lens) + 3
    k = torch.randn((P, ps, H, D), generator=gen, device=cuda)
    v = torch.randn((P, ps, H, D), generator=gen, device=cuda)
    pos = torch.full((P, ps), -1, dtype=torch.int32, device=cuda)
    tbl = torch.ones((B, nv), dtype=torch.int32, device=cuda)
    free = (torch.randperm(P - 2, generator=torch.Generator().manual_seed(0))
            + 2).tolist()
    for b, n in enumerate(lens):
        for j in range(-(-n // ps)):
            page = free.pop()
            cnt = min(ps, n - j * ps)
            pos[page, :cnt] = j * ps + torch.arange(cnt, dtype=torch.int32,
                                                    device=cuda)
            tbl[b, j] = page
    q = torch.randn((B, T, H, G, D), generator=gen, device=cuda)
    qp = torch.tensor([[max(n - T + t, 0) for t in range(T)] for n in lens],
                      dtype=torch.int32, device=cuda)
    for window in (0, 50):
        got = pa.paged_attend_partial(q, k, v, qp, pos, tbl, scale=D ** -0.5,
                                      window=window)
        want = pa.paged_attend_partial_plain(q, k, v, qp, pos, tbl,
                                             scale=D ** -0.5, window=window)
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
        k1 = fa.attend_partial(q, pa.gather_view(k, tbl),
                               pa.gather_view(v, tbl), qp,
                               pa.gather_view(pos, tbl), scale=D ** -0.5,
                               window=window)
        for a, b in zip(got, k1):
            assert torch.equal(a, b)


def _int8_kv(gen, shape, cuda):
    """Random K or V quantized as an int8 cache stores it: (int8, f32
    scale per row and head)."""
    from repro_torch.models.attention import _quantize
    return _quantize(torch.randn(shape, generator=gen, device=cuda))


@pytest.mark.gpu
@pytest.mark.parametrize("qdtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D,G,T", [(64, 7, 1), (128, 1, 10), (32, 2, 40),
                                   (16, 4, 3), (128, 4, 6),
                                   # phase K's widths (target D 128, G 1;
                                   # drafter D 64, G 7): decode, cache
                                   # pass, commit, a 512-token prefill
                                   (128, 1, 1), (128, 1, 6), (128, 1, 512),
                                   (64, 7, 10), (64, 7, 6), (64, 7, 512)])
def test_int8_kv_kernel1_matches_plain(cuda, D, G, T, qdtype):
    """Kernel 1's int8 K/V form against its plain version (the
    reference's dequantized bf16 view through the plain partials): a slot
    pool read in place with its scales, plain causal, a mask, a window and
    a fully masked row, at 16-row blocks (R <= 16) and 64-row blocks. Each
    value is dequantized to the same bf16 and the products run on bf16
    tensor cores with q and P split into two bf16 halves (about 2^-17),
    so the difference is of the order of f32 summation order: rtol = atol
    = 1e-4. Two runs give the same bits."""
    gen = torch.Generator(device=cuda).manual_seed(D + T)
    B, H, P, C = 3, 2, 5, 300
    q = torch.randn((B, T, H, G, D), generator=gen, device=cuda).to(qdtype)
    k8, ks = _int8_kv(gen, (P, C, H, D), cuda)
    v8, vs = _int8_kv(gen, (P, C, H, D), cuda)
    kpos = torch.arange(C, dtype=torch.int32, device=cuda).repeat(P, 1)
    kpos[:, 250:] = -1
    kpos[2] = -1                                   # an empty slot
    qpos = (240 + torch.arange(T, dtype=torch.int32, device=cuda)).repeat(B, 1)
    slot_idx = torch.tensor([4, 0, 2], dtype=torch.int32, device=cuda)
    mask = torch.rand((B, T, C), generator=gen, device=cuda) < 0.7
    sc = dict(k_scale=ks, v_scale=vs, slot_idx=slot_idx, scale=D ** -0.5)
    for kw in (dict(), dict(mask=mask), dict(window=50),
               dict(causal=False)):
        before = fa.LAUNCHES
        got = fa.attend_partial(q, k8, v8, qpos, kpos, **sc, **kw)
        assert fa.LAUNCHES == before + 1
        want = fa.attend_partial_plain(q, k8, v8, qpos, kpos, **sc, **kw)
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
        assert float(got[1][2].abs().max()) == 0.0   # empty slot: l = 0
        for a, b in zip(got, fa.attend_partial(q, k8, v8, qpos, kpos,
                                               **sc, **kw)):
            assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("ps", [16, 64])
@pytest.mark.parametrize("T,G,D", [(1, 7, 64), (10, 1, 128), (6, 4, 128),
                                   (40, 2, 32)])
def test_int8_kv_paged_matches_plain_and_kernel1(cuda, ps, T, G, D):
    """The paged kernel's int8 form against its plain version (1e-4) and
    bit for bit against kernel 1's int8 form on the gathered view (pool
    and scales), pages in scrambled order, NULL filler, a window."""
    gen = torch.Generator(device=cuda).manual_seed(ps * T + D)
    B, H, nv = 3, 2, 16
    lens = [5 * ps + 3, ps, 7]
    P = 2 + sum(-(-n // ps) for n in lens) + 3
    k8, ks = _int8_kv(gen, (P, ps, H, D), cuda)
    v8, vs = _int8_kv(gen, (P, ps, H, D), cuda)
    pos = torch.full((P, ps), -1, dtype=torch.int32, device=cuda)
    tbl = torch.ones((B, nv), dtype=torch.int32, device=cuda)
    free = (torch.randperm(P - 2, generator=torch.Generator().manual_seed(2))
            + 2).tolist()
    for b, n in enumerate(lens):
        for j in range(-(-n // ps)):
            page = free.pop()
            cnt = min(ps, n - j * ps)
            pos[page, :cnt] = j * ps + torch.arange(cnt, dtype=torch.int32,
                                                    device=cuda)
            tbl[b, j] = page
    q = torch.randn((B, T, H, G, D), generator=gen, device=cuda)
    qp = torch.tensor([[max(n - T + t, 0) for t in range(T)] for n in lens],
                      dtype=torch.int32, device=cuda)
    for window in (0, 50):
        kw = dict(scale=D ** -0.5, window=window)
        before = pa.LAUNCHES
        got = pa.paged_attend_partial(q, k8, v8, qp, pos, tbl, k_scale=ks,
                                      v_scale=vs, **kw)
        assert pa.LAUNCHES == before + 1
        want = pa.paged_attend_partial_plain(q, k8, v8, qp, pos, tbl,
                                             k_scale=ks, v_scale=vs, **kw)
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
        g = pa.gather_view
        k1 = fa.attend_partial(q, g(k8, tbl), g(v8, tbl), qp, g(pos, tbl),
                               k_scale=g(ks, tbl), v_scale=g(vs, tbl), **kw)
        for a, b in zip(got, k1):
            assert torch.equal(a, b)


@pytest.mark.gpu
def test_int8_kv_wrappers_raise_instead_of_falling_back(cuda):
    """An int8 pool the kernels cannot take raises ValueError on the card
    and launches nothing: int8 K/V without scales, scales on f32 K/V, one
    scale missing, scales of the wrong shape or dtype."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    B, T, H, G, D, S, ps = 2, 1, 2, 4, 64, 64, 16
    q = torch.randn((B, T, H, G, D), generator=gen, device=cuda)
    qpos = torch.full((B, T), S - 1, dtype=torch.int32, device=cuda)
    kpos = torch.arange(S, dtype=torch.int32, device=cuda).repeat(B, 1)
    tbl = torch.arange(B * S // ps, dtype=torch.int32,
                       device=cuda).reshape(B, S // ps)

    def bad(lead):
        k8, ks = _int8_kv(gen, lead + (H, D), cuda)
        v8, vs = _int8_kv(gen, lead + (H, D), cuda)
        kf = torch.randn(lead + (H, D), generator=gen, device=cuda)
        return [(k8, v8, {}), (kf, kf, dict(k_scale=ks, v_scale=vs)),
                (k8, v8, dict(k_scale=ks)),
                (k8, v8, dict(k_scale=ks[..., :-1], v_scale=vs[..., :-1])),
                (k8, v8, dict(k_scale=ks.double(), v_scale=vs.double()))]

    before = (fa.LAUNCHES, pa.LAUNCHES)
    for k, v, kw in bad((B, S)):
        with pytest.raises(ValueError):
            fa.attend_partial(q, k, v, qpos, kpos, scale=D ** -0.5, **kw)
    for k, v, kw in bad((B * S // ps, ps)):
        with pytest.raises(ValueError):
            pa.paged_attend_partial(q, k, v, qpos,
                                    kpos.reshape(B * S // ps, ps), tbl,
                                    scale=D ** -0.5, **kw)
    assert (fa.LAUNCHES, pa.LAUNCHES) == before


@pytest.mark.gpu
@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("T,G", [(1, 7), (10, 1), (512, 1)])
def test_int8_kv_same_bits_in_graph_on_stream_and_twice(cuda, T, G, paged):
    """The int8 K/V form (16-row and 64-row blocks, kernel 1 and the paged
    kernel) launches once per call and gives the same bits from the
    default stream, a second run, a second stream and a CUDA graph replay
    (no atomics, partials merged in a fixed order, no state kept between
    calls)."""
    gen = torch.Generator(device=cuda).manual_seed(T + G)
    B, H, D, ps = 2, 2, 64, 64
    S = 1024
    q = torch.randn((B, T, H, G, D), generator=gen, device=cuda)
    lens = [min(S, 700), 90]
    qpos = torch.tensor([[max(n - T, 0) + t for t in range(T)]
                         for n in lens], dtype=torch.int32, device=cuda)
    if paged:
        P = 2 + B * S // ps
        k8, ks = _int8_kv(gen, (P, ps, H, D), cuda)
        v8, vs = _int8_kv(gen, (P, ps, H, D), cuda)
        pos = torch.full((P, ps), -1, dtype=torch.int32, device=cuda)
        tbl = torch.arange(2, P, dtype=torch.int32,
                           device=cuda).view(B, S // ps)
        for b, n in enumerate(lens):
            flat = torch.full((S,), -1, dtype=torch.int32, device=cuda)
            flat[:n] = torch.arange(n, dtype=torch.int32, device=cuda)
            pos[tbl[b].long()] = flat.view(-1, ps)

        def call():
            return pa.paged_attend_partial(q, k8, v8, qpos, pos, tbl,
                                           scale=D ** -0.5, k_scale=ks,
                                           v_scale=vs)
        counter = pa
    else:
        k8, ks = _int8_kv(gen, (B, S, H, D), cuda)
        v8, vs = _int8_kv(gen, (B, S, H, D), cuda)
        kpos = torch.full((B, S), -1, dtype=torch.int32, device=cuda)
        for b, n in enumerate(lens):
            kpos[b, :n] = torch.arange(n, dtype=torch.int32, device=cuda)

        def call():
            return fa.attend_partial(q, k8, v8, qpos, kpos, scale=D ** -0.5,
                                     k_scale=ks, v_scale=vs)
        counter = fa
    before = (counter.LAUNCHES, counter.LAUNCHES_INT8_KV)
    ref = call()
    assert (counter.LAUNCHES, counter.LAUNCHES_INT8_KV) == (
        before[0] + 1, before[1] + 1)
    for a, b in zip(call(), ref):
        assert torch.equal(a, b)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        on_side = call()
    torch.cuda.current_stream().wait_stream(side)
    for a, b in zip(on_side, ref):
        assert torch.equal(a, b)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        captured = call()
    g.replay()
    torch.cuda.synchronize()
    for a, b in zip(captured, ref):
        assert torch.equal(a, b)


def _latent_pool(gen, cuda, Dk, Dv, dtype, P, S, lens):
    """A latent slot pool (one KV head) whose slot i holds positions
    [0, lens[i]), and its k/v of (P, S, 1, Dk/Dv) in `dtype`."""
    k = torch.randn((P, S, 1, Dk), generator=gen, device=cuda).to(dtype)
    v = torch.randn((P, S, 1, Dv), generator=gen, device=cuda).to(dtype)
    kpos = torch.full((P, S), -1, dtype=torch.int32, device=cuda)
    for slot, n in enumerate(lens):
        kpos[slot, :n] = torch.arange(n, dtype=torch.int32, device=cuda)
    return k, v, kpos


@pytest.mark.gpu
@pytest.mark.parametrize("v_in_k", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Dk,Dv,G", [(40, 32, 4), (576, 512, 128)])
@pytest.mark.parametrize("T", [1, 6, 64])
def test_latent_kernel1_matches_plain(cuda, Dk, Dv, G, T, dtype, v_in_k):
    """Kernel 1's latent form (Dk != Dv, one KV head, every query head
    folded into G) against its plain version at the tiny pair and at
    DeepSeek-V3's (576, 512): a scrambled slot pool read in place, plain
    causal, a tree mask, a window, f32 and bf16 q, with `v` its own tile
    or K's first Dv columns (`v_in_k`), split over a cluster (T 1, 6) or
    not (T 64 at G 128). The tensor cores' 3xTF32 products and another
    summation order, so rtol = atol = 1e-4; a second run gives the same
    bits."""
    gen = torch.Generator(device=cuda).manual_seed(Dk + T)
    B, P, S = 3, 6, 512
    lens = [0, 300, 0, 57, 511, 200]
    k, v, kpos = _latent_pool(gen, cuda, Dk, Dv, dtype, P, S, lens)
    if v_in_k:
        v = k[..., :Dv]
    assert fa.v_in_k(k, v) == v_in_k
    slot_idx = torch.tensor([4, 1, 3], dtype=torch.int32, device=cuda)
    cur = torch.tensor([lens[4], lens[1], lens[3]], device=cuda)
    qpos = (cur[:, None] - T + torch.arange(T, device=cuda)).to(torch.int32)
    mask = torch.rand((B, T, S), generator=gen, device=cuda) < 0.6
    for qdtype in (torch.float32, torch.bfloat16):
        q = torch.randn((B, T, 1, G, Dk), generator=gen,
                        device=cuda).to(qdtype)
        for kw in (dict(), dict(mask=mask), dict(window=64)):
            got = fa.attend_partial(q, k, v, qpos, kpos, scale=Dk ** -0.5,
                                    slot_idx=slot_idx, **kw)
            want = fa.attend_partial_plain(
                q, k, v, qpos, kpos, scale=Dk ** -0.5, slot_idx=slot_idx,
                block=fa.key_tile(Dk, Dv), **kw)
            for a, b in zip(got, want):
                torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
            again = fa.attend_partial(q, k, v, qpos, kpos, scale=Dk ** -0.5,
                                      slot_idx=slot_idx, **kw)
            assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.gpu
@pytest.mark.parametrize("v_in_k", [False, True])
@pytest.mark.parametrize("Dk,Dv,G", [(40, 32, 4), (576, 512, 128)])
@pytest.mark.parametrize("T", [1, 10, 64])
def test_latent_paged_bitwise_kernel1(cuda, Dk, Dv, G, T, v_in_k):
    """The paged kernel's latent form on a scrambled page pool (page_size
    64, NULL filler entries) equals kernel 1's latent form on the
    gathered view bit for bit, with `v` its own pool or K's first Dv
    columns on both sides, and its plain version within 1e-4."""
    gen = torch.Generator(device=cuda).manual_seed(Dk * T)
    B, ps, nv = 3, 64, 8
    lens = [5 * ps + 3, ps, T + 2]
    P = 2 + sum(-(-n // ps) for n in lens) + 3
    k = torch.randn((P, ps, 1, Dk), generator=gen, device=cuda)
    v = torch.randn((P, ps, 1, Dv), generator=gen, device=cuda)
    pos = torch.full((P, ps), -1, dtype=torch.int32, device=cuda)
    tbl = torch.ones((B, nv), dtype=torch.int32, device=cuda)
    free = (torch.randperm(P - 2, generator=torch.Generator().manual_seed(2))
            + 2).tolist()
    for b, n in enumerate(lens):
        for j in range(-(-n // ps)):
            page = free.pop()
            cnt = min(ps, n - j * ps)
            pos[page, :cnt] = j * ps + torch.arange(cnt, dtype=torch.int32,
                                                    device=cuda)
            tbl[b, j] = page
    q = torch.randn((B, T, 1, G, Dk), generator=gen, device=cuda)
    qp = torch.tensor([[max(n - T + t, 0) for t in range(T)] for n in lens],
                      dtype=torch.int32, device=cuda)
    kg = pa.gather_view(k, tbl)
    vg = kg[..., :Dv] if v_in_k else pa.gather_view(v, tbl)
    if v_in_k:
        v = k[..., :Dv]
    assert fa.v_in_k(k, v) == fa.v_in_k(kg, vg) == v_in_k
    before = (fa.LAUNCHES_LATENT, pa.LAUNCHES_LATENT)
    got = pa.paged_attend_partial(q, k, v, qp, pos, tbl, scale=Dk ** -0.5)
    k1 = fa.attend_partial(q, kg, vg, qp, pa.gather_view(pos, tbl),
                           scale=Dk ** -0.5)
    assert (fa.LAUNCHES_LATENT, pa.LAUNCHES_LATENT) == (before[0] + 1,
                                                        before[1] + 1)
    for a, b in zip(got, k1):
        assert torch.equal(a, b)
    want = pa.paged_attend_partial_plain(q, k, v, qp, pos, tbl,
                                         scale=Dk ** -0.5,
                                         block=fa.key_tile(Dk, Dv))
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Dk,Dv,G", [(40, 32, 4), (576, 512, 128)])
@pytest.mark.parametrize("T", [1, 10])
def test_latent_v_in_k_bitwise_cloned_v(cuda, Dk, Dv, G, T, dtype):
    """V read out of K's tile (`v = k[..., :Dv]`) and V staged from a
    clone of those columns give bitwise equal partials, on kernel 1 (a
    slot pool, and a q view whose rows are not 16-byte aligned, which the
    wrapper copies) and on the paged kernel; each call is one latent
    launch."""
    gen = torch.Generator(device=cuda).manual_seed(Dk * 3 + T)
    P, S, lens = 6, 320, [0, 300, 0, 57, 319, 200]
    k, _, kpos = _latent_pool(gen, cuda, Dk, Dv, dtype, P, S, lens)
    sidx = torch.tensor([4, 1, 3], dtype=torch.int32, device=cuda)
    qpos = (torch.tensor([lens[4], lens[1], lens[3]], device=cuda)[:, None]
            - T + torch.arange(T, device=cuda)).to(torch.int32)
    wide = torch.randn((3, T, 1, G, Dk + 1), generator=gen, device=cuda)
    q_odd = wide[..., :Dk]
    assert not fa.rows_aligned(q_odd)
    kw = dict(scale=Dk ** -0.5, slot_idx=sidx)
    alias = fa.attend_partial(q_odd, k, k[..., :Dv], qpos, kpos, **kw)
    cloned = fa.attend_partial(q_odd.contiguous(), k, k[..., :Dv].clone(),
                               qpos, kpos, **kw)
    assert all(torch.equal(a, b) for a, b in zip(alias, cloned))
    pk = k.reshape(P * S // 64, 64, 1, Dk)
    pos = kpos.reshape(P * S // 64, 64)
    tbl = torch.arange(P * S // 64, dtype=torch.int32,
                       device=cuda).reshape(P, S // 64)[sidx.long()]
    before = pa.LAUNCHES_LATENT
    palias = pa.paged_attend_partial(q_odd, pk, pk[..., :Dv], qpos, pos, tbl,
                                     scale=Dk ** -0.5)
    pcloned = pa.paged_attend_partial(q_odd, pk, pk[..., :Dv].clone(), qpos,
                                      pos, tbl, scale=Dk ** -0.5)
    assert pa.LAUNCHES_LATENT == before + 2
    assert all(torch.equal(a, b) for a, b in zip(palias, pcloned))
    assert all(torch.equal(a, b) for a, b in zip(palias, alias))


@pytest.mark.gpu
def test_latent_wrappers_refuse_other_pairs(cuda):
    """On the card a (Dk, Dv) pair without an instantiation, and int8 K/V
    in the latent form, raise ValueError naming what is supported, and
    launch nothing: no plain or library fallback."""
    gen = torch.Generator(device=cuda).manual_seed(9)
    B, T, G, S, ps = 2, 1, 4, 64, 16
    qpos = torch.full((B, T), S - 1, dtype=torch.int32, device=cuda)
    kpos = torch.arange(S, dtype=torch.int32, device=cuda).repeat(B, 1)
    tbl = torch.arange(B * S // ps, dtype=torch.int32,
                       device=cuda).reshape(B, S // ps)
    before = (fa.LAUNCHES, pa.LAUNCHES)
    for Dk, Dv, kvd in ((64, 32, torch.float32), (576, 256, torch.float32),
                        (128, 64, torch.bfloat16), (40, 32, torch.int8)):
        q = torch.randn((B, T, 1, G, Dk), generator=gen, device=cuda)
        k = torch.zeros((B, S, 1, Dk), dtype=kvd, device=cuda)
        v = torch.zeros((B, S, 1, Dv), dtype=kvd, device=cuda)
        sc = {}
        if kvd == torch.int8:
            sc = dict(k_scale=torch.ones((B, S, 1), device=cuda),
                      v_scale=torch.ones((B, S, 1), device=cuda))
        with pytest.raises(ValueError, match="supported pairs|latent form"):
            fa.attend_partial(q, k, v, qpos, kpos, scale=0.1, **sc)
        pk, pv = (t.reshape(B * S // ps, ps, 1, -1) for t in (k, v))
        psc = {n: t.reshape(B * S // ps, ps, 1) for n, t in sc.items()}
        with pytest.raises(ValueError, match="supported pairs|latent form"):
            pa.paged_attend_partial(q, pk, pv, qpos,
                                    kpos.reshape(B * S // ps, ps), tbl,
                                    scale=0.1, **psc)
    assert (fa.LAUNCHES, pa.LAUNCHES) == before


def _tiny_models(cuda):
    tcfg = ModelConfig(name="t", family="dense", n_layers=2, d_model=128,
                       n_heads=4, n_kv_heads=2, head_dim=32, d_ff=256,
                       vocab=300, tie_embeddings=True, dtype="float32")
    dcfg = tcfg.with_overrides(name="d", n_layers=1, n_heads=2, head_dim=64)
    return tcfg, dcfg, M.init_params(tcfg, 0)


def _greedy(tcfg, tp, prompt, n, cuda):
    cache = M.init_cache(tcfg, 1, 128, dtype=torch.float32)
    lg, cache, _ = M.prefill(tp, tcfg, torch.tensor([prompt], device=cuda),
                             cache)
    ref = []
    for _ in range(n):
        ref.append(int(torch.argmax(lg[0, -1, : tcfg.vocab])))
        lg, cache, _ = M.decode_step(
            tp, tcfg, torch.tensor([[ref[-1]]], device=cuda), cache)
    return ref


def _engine_is_greedy_exact(cuda, pool):
    tcfg, dcfg, tp = _tiny_models(cuda)
    perfect = (int8_variant(tcfg) if pool == "mixed int8" else tcfg)
    cos = CoSineConfig(n_drafters=2, paged_pool=pool == "paged",
                       page_size=16, pool_pages=4)
    eng = SpeculativeEngine((tcfg, tp), [(dcfg, M.init_params(dcfg, 1), "a"),
                                         (perfect, tp, "b")],
                            cos, max_len=128, seed=0)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, 300, n).tolist() for n in (5, 17, 40)]
    reqs = [eng.submit(p, max_new_tokens=16) for p in prompts]
    fa.LAUNCHES = pa.LAUNCHES = ig.LAUNCHES = 0
    stats = eng.run()
    assert fa.LAUNCHES > 0 and stats.mean_acceptance > 1.0
    if pool == "paged":
        assert pa.LAUNCHES > 0 and eng.target.slots.n_page_growths > 0
    if pool == "mixed int8":
        assert ig.LAUNCHES > 0
    for r, p in zip(reqs, prompts):
        assert list(map(int, r.generated)) == _greedy(tcfg, tp, p, 16, cuda)


@pytest.mark.gpu
@pytest.mark.parametrize("paged", [False, True])
def test_cuda_engine_mla_is_greedy_exact(cuda, paged):
    """A tiny MLA target (the latent form's (40, 32) pair: kv_lora 32,
    rope 8, 4 heads) with a random MLA drafter and a drafter sharing its
    weights, on the card, resident and on a paged pool that must grow:
    the greedy stream committed, every attention call (cache reads and
    segment passes) on the kernels' latent form."""
    from repro_torch.config import MLAConfig
    tcfg = ModelConfig(name="t-mla", family="dense", attention="mla",
                       mla=MLAConfig(q_lora_rank=32, kv_lora_rank=32,
                                     qk_nope_head_dim=16, qk_rope_head_dim=8,
                                     v_head_dim=16),
                       n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                       head_dim=16, d_ff=128, vocab=300, tie_embeddings=True,
                       dtype="float32")
    dcfg = tcfg.with_overrides(name="d-mla", n_layers=1)
    tp = M.init_params(tcfg, 0)
    cos = CoSineConfig(n_drafters=2, paged_pool=paged, page_size=16,
                       pool_pages=4)
    eng = SpeculativeEngine((tcfg, tp), [(dcfg, M.init_params(dcfg, 1), "a"),
                                         (tcfg, tp, "b")],
                            cos, max_len=128, seed=0)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, 300, n).tolist() for n in (5, 17, 40)]
    reqs = [eng.submit(p, max_new_tokens=16) for p in prompts]
    fa.LAUNCHES = pa.LAUNCHES = 0
    fa.LAUNCHES_LATENT = pa.LAUNCHES_LATENT = 0
    stats = eng.run()
    assert stats.mean_acceptance > 1.0
    assert (fa.LAUNCHES_LATENT, pa.LAUNCHES_LATENT) == (fa.LAUNCHES,
                                                        pa.LAUNCHES)
    assert fa.LAUNCHES > 0 and (pa.LAUNCHES > 0) == paged
    if paged:
        assert eng.target.slots.n_page_growths > 0
    for r, p in zip(reqs, prompts):
        assert list(map(int, r.generated)) == _greedy(tcfg, tp, p, 16, cuda)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["cross", "encdec", "d120"])
def test_cuda_cross_encdec_and_d120_models(cuda, arch):
    """Tiny cross-attention, encoder-decoder and head-width-120 (SWA)
    models on the card: `apply(frontend=...)` within 1e-4 of the same
    weights on the CPU (the encoder's and the cross reads on kernel 1's
    non-causal form), then a `cosine` engine (a random drafter and one
    sharing the target's weights) commits the greedy streams."""
    base = ModelConfig(name="t-x", family="dense", n_layers=2, d_model=64,
                       n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128,
                       vocab=300, tie_embeddings=True, dtype="float32")
    tcfg = {"cross": base.with_overrides(cross_attn_period=2,
                                         n_frontend_tokens=40),
            "encdec": base.with_overrides(
                family="audio", n_kv_heads=4, norm_type="layer",
                mlp_type="gelu", pos_embed="learned", max_position=256,
                encoder_layers=2, encoder_seq=50, n_frontend_tokens=50),
            "d120": base.with_overrides(head_dim=120, attention="swa",
                                        sliding_window=24)}[arch]
    tp = M.init_params(tcfg, 0)
    if arch != "d120":
        gen = torch.Generator(device=cuda).manual_seed(1)
        toks = torch.randint(0, 300, (2, 9), generator=gen, device=cuda)
        fe = 0.1 * torch.randn((2, tcfg.n_frontend_tokens, 64),
                               generator=gen, device=cuda)
        fa.LAUNCHES = 0
        got, _, _ = M.apply(tp, tcfg, toks, frontend=fe)
        assert fa.LAUNCHES > 0
        want, _, _ = M.apply(_to(tp, "cpu"), tcfg, toks.cpu(),
                             frontend=fe.cpu())
        torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    cos = CoSineConfig(n_drafters=2, page_size=16, pool_pages=4)
    eng = SpeculativeEngine((tcfg, tp), [(tcfg, M.init_params(tcfg, 1), "a"),
                                         (tcfg, tp, "b")],
                            cos, max_len=128, seed=0)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, 300, n).tolist() for n in (5, 17, 40)]
    reqs = [eng.submit(p, max_new_tokens=16) for p in prompts]
    fa.LAUNCHES = 0
    stats = eng.run()
    assert fa.LAUNCHES > 0 and stats.mean_acceptance > 1.0
    for r, p in zip(reqs, prompts):
        assert list(map(int, r.generated)) == _greedy(tcfg, tp, p, 16, cuda)


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


@pytest.mark.gpu
def test_cuda_engine_is_greedy_exact(cuda):
    """The cosine engine on the card (random drafter + perfect drafter,
    float32 tiny models) commits the target's greedy stream, and every
    attention of the run launched the kernel."""
    _engine_is_greedy_exact(cuda, "resident")


@pytest.mark.gpu
@pytest.mark.parametrize("pool", ["paged", "mixed int8"])
def test_cuda_engine_paged_and_int8_are_greedy_exact(cuda, pool):
    """The same on a paged pool that must grow (every pool read on the
    paged kernel) and with an int8 copy of the target as one drafter
    (every quantized product on the int8 kernel)."""
    _engine_is_greedy_exact(cuda, pool)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["moe", "int8 kv", "int8 kv paged"])
def test_cuda_engine_moe_and_int8_kv_are_greedy_exact(cuda, case):
    """The cosine engine on the card with a MoE target (routed experts
    and a shared one, drafters sharing its weights) and with int8 KV
    caches for target and drafters, resident and on a paged pool that
    must grow: greedy-exact, every cache read on the kernels' int8 form
    (no plain call), and the paged pool commits the resident pool's
    tokens."""
    from repro_torch.config import MoEConfig
    tcfg, dcfg, _ = _tiny_models(cuda)
    if case == "moe":
        tcfg = tcfg.with_overrides(family="moe", moe=MoEConfig(
            n_routed=4, top_k=2, d_ff=64, n_shared=1, shared_d_ff=128))
    else:
        tcfg = tcfg.with_overrides(kv_dtype="int8")
        dcfg = dcfg.with_overrides(kv_dtype="int8")
    tp = M.init_params(tcfg, 0)
    drafters = [(dcfg, M.init_params(dcfg, 1), "a"), (tcfg, tp, "b")]
    streams = {}
    for paged in ((False, True) if case == "int8 kv paged" else (False,)):
        cos = CoSineConfig(n_drafters=2, paged_pool=paged, page_size=16,
                           pool_pages=4)
        eng = SpeculativeEngine((tcfg, tp), drafters, cos, max_len=128,
                                seed=0)
        rng = np.random.default_rng(0)
        prompts = [rng.integers(1, 300, n).tolist() for n in (5, 17, 40)]
        reqs = [eng.submit(p, max_new_tokens=16) for p in prompts]
        fa.LAUNCHES = pa.LAUNCHES = 0
        stats = eng.run()
        assert stats.mean_acceptance > 1.0
        assert (pa.LAUNCHES > 0) == paged and fa.LAUNCHES > 0
        streams[paged] = [list(map(int, r.generated)) for r in reqs]
        for got, p in zip(streams[paged], prompts):
            assert got == _greedy(tcfg, tp, p, 16, cuda)
    if len(streams) == 2:
        assert streams[True] == streams[False]


# (b, L, H, P, G, N): mamba2-130m prefill chunk, decode at the slot
# bucket, a verification chain and a ragged final prefill chunk; jamba's
# widths at prefill and decode; a case with G > 1
SSD_SHAPES = [(1, 512, 24, 64, 1, 128), (4, 1, 24, 64, 1, 128),
              (4, 5, 24, 64, 1, 128), (1, 88, 24, 64, 1, 128),
              (1, 512, 128, 64, 1, 16), (4, 1, 128, 64, 1, 16),
              (2, 77, 8, 32, 4, 16)]


def _ssd_inputs(gen, b, L, H, P, G, N, dtype, cuda):
    """Inputs distributed as the mixer makes them: dt = softplus(z + the
    mixer's dt_bias), A = -(1..16), an initial state."""
    x = torch.randn((b, L, H, P), generator=gen, device=cuda).to(dtype)
    z = torch.randn((b, L, H), generator=gen, device=cuda)
    dt = torch.nn.functional.softplus(z + float(np.log(np.expm1(0.01))))
    A = -torch.linspace(1.0, 16.0, H, device=cuda)
    B = torch.randn((b, L, G, N), generator=gen, device=cuda).to(dtype)
    C = torch.randn((b, L, G, N), generator=gen, device=cuda).to(dtype)
    s0 = 0.1 * torch.randn((b, H, P, N), generator=gen, device=cuda)
    return x, dt, A, B, C, s0


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("init", [False, True])
@pytest.mark.parametrize("shape", SSD_SHAPES)
def test_ssd_kernel_matches_plain(cuda, shape, init, dtype):
    """The SSD kernel against its plain version (chunk 128) on the same
    inputs: y and the final state. Both sum in f32 in other orders and
    chunkings: rtol = atol = 2e-4, the reference's own tolerance. A bf16
    y is the kernel's f32 value rounded once to bf16, so it is held
    against the plain version's f32 y (on the same bf16 inputs) within
    that tolerance plus one bf16 ulp of the f32 value."""
    gen = torch.Generator(device=cuda).manual_seed(sum(shape))
    x, dt, A, B, C, s0 = _ssd_inputs(gen, *shape, dtype, cuda)
    s0 = s0 if init else None
    y, s = ssd.ssd(x, dt, A, B, C, 128, s0)
    yp, sp = ssd.ssd_chunked(x.float(), dt, A, B.float(), C.float(), 128,
                             s0)
    assert y.dtype == x.dtype and s.dtype == torch.float32
    if dtype == torch.float32:
        torch.testing.assert_close(y, yp, rtol=2e-4, atol=2e-4)
    else:
        _, e = torch.frexp(yp)        # yp = m 2^e, 1/2 <= |m| < 1
        ulp = torch.where(yp == 0, torch.zeros_like(yp),
                          torch.ldexp(torch.ones_like(yp), e - 8))
        err = (y.float() - yp).abs()
        assert bool((err <= 2e-4 + 2e-4 * yp.abs() + ulp).all()), float(
            (err - 2e-4 - 2e-4 * yp.abs() - ulp).max())
    torch.testing.assert_close(s, sp, rtol=2e-4, atol=2e-4)


@pytest.mark.gpu
def test_ssd_kernel_masked_tail_and_strided_views(cuda):
    """dt = 0 tokens leave the state unchanged; x, B and C given as views
    of one wider tensor (the mixer's layout) need no copy and give the
    contiguous result."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    b, L, H, P, G, N, n = 2, 40, 4, 16, 2, 8, 23
    x, dt, A, B, C, s0 = _ssd_inputs(gen, b, L, H, P, G, N, torch.float32,
                                     cuda)
    dt[:, n:] = 0.0
    y, s = ssd.ssd(x, dt, A, B, C, 16, s0)
    yp, sp = ssd.ssd(x[:, :n].contiguous(), dt[:, :n].contiguous(), A,
                     B[:, :n].contiguous(), C[:, :n].contiguous(), 16, s0)
    torch.testing.assert_close(s, sp, rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(y[:, :n], yp, rtol=2e-4, atol=2e-4)
    wide = torch.cat([x.reshape(b, L, H * P), B.reshape(b, L, G * N),
                      C.reshape(b, L, G * N)], dim=-1)
    xv = wide[..., : H * P].reshape(b, L, H, P)
    Bv = wide[..., H * P: H * P + G * N].reshape(b, L, G, N)
    Cv = wide[..., H * P + G * N:].reshape(b, L, G, N)
    assert not xv.is_contiguous()
    yv, sv = ssd.ssd(xv, dt, A, Bv, Cv, 16, s0)
    assert torch.equal(yv, y) and torch.equal(sv, s)


def _ssd_close(y, st, yp, sp, dtype):
    """The module's 2e-4 rule: y and the state within rtol = atol = 2e-4 of
    the plain version; a bf16 y within that plus one bf16 ulp of the f32
    value (it is the kernel's f32 value rounded once)."""
    assert torch.isfinite(y.float()).all() and torch.isfinite(st).all()
    if dtype == torch.float32:
        torch.testing.assert_close(y, yp, rtol=2e-4, atol=2e-4)
    else:
        _, e = torch.frexp(yp)
        ulp = torch.where(yp == 0, torch.zeros_like(yp),
                          torch.ldexp(torch.ones_like(yp), e - 8))
        err = (y.float() - yp).abs()
        assert bool((err <= 2e-4 + 2e-4 * yp.abs() + ulp).all()), float(
            (err - 2e-4 - 2e-4 * yp.abs() - ulp).max())
    torch.testing.assert_close(st, sp, rtol=2e-4, atol=2e-4)


def _ssd_plans(b, L, H, P, N, dtype, path):
    """The plans of one path the kernel can be given at a shape: the
    recurrence's, or the chunk path's at every state slice and block
    size its plan can pick (8 rows up to its widest; 8 or 16 warps), the
    plan's own first."""
    if path == "rec":
        return [ssd.rec_plan(P, N)]
    esize = 2 if dtype == torch.bfloat16 else 4
    base = ssd.chunk_plan(b, L, H, P, N, esize)
    widest = ssd.slice_max(P, N)
    return [base] + [
        base._replace(pb=pb, threads=threads,
                      smem=ssd.chunk_smem(base.q, N, pb, esize))
        for pb in (8, 16, 32, 64, 128) if pb <= widest and P % pb == 0
        for threads in (ssd.CHUNK_THREADS_TWO, ssd.CHUNK_THREADS_ONE)
        if (pb, threads) != (base.pb, base.threads)]


# (b, L, H, P, G, N): the served widths at decode, verify and extend
# lengths on both sides of REC_MAX_L, a ragged chunk, N = 8 (padded to the
# 16-row tile), N = 256 (8 columns a thread) and P = 128
SSD_PATH_SHAPES = [(4, 1, 24, 64, 1, 128), (4, 6, 24, 64, 1, 128),
                   (1, 40, 24, 64, 1, 128), (2, 77, 24, 64, 4, 128),
                   (4, 6, 128, 64, 1, 16), (1, 130, 128, 64, 1, 16),
                   (2, 37, 4, 16, 2, 8), (1, 20, 2, 64, 1, 256),
                   (3, 19, 2, 128, 1, 32)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("path", ["rec", "chunk"])
@pytest.mark.parametrize("shape", SSD_PATH_SHAPES)
def test_ssd_each_path_and_slice_matches_plain(cuda, shape, path, dtype):
    """Each path, at each state slice its plan can pick, against the plain
    version (chunk 128), with and without an initial state, under the 2e-4
    rule; every slice gives the same bits (a column's arithmetic does not
    depend on which block computes it)."""
    b, L, H, P, G, N = shape
    gen = torch.Generator(device=cuda).manual_seed(sum(shape))
    x, dt, A, B, C, s0 = _ssd_inputs(gen, b, L, H, P, G, N, dtype, cuda)
    for init in (None, s0):
        yp, sp = ssd.ssd_chunked(x.float(), dt, A, B.float(), C.float(),
                                 128, init)
        first = None
        for p in _ssd_plans(b, L, H, P, N, dtype, path):
            st = torch.full_like(s0, float("nan"))
            y = ssd.launch_plan(x, dt, A, B, C, init, st, None, p)
            torch.cuda.synchronize()
            _ssd_close(y, st, yp, sp, dtype)
            if first is None:
                first = (y, st)
            else:
                assert torch.equal(y, first[0]) and torch.equal(st, first[1])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("path", ["rec", "chunk"])
@pytest.mark.parametrize("shape", [(4, 1, 24, 64, 1, 128),
                                   (4, 6, 128, 64, 1, 16),
                                   (3, 21, 8, 32, 2, 16)])
def test_ssd_slots_in_place_scrambled(cuda, shape, path, dtype):
    """The in-place form with slot_idx scrambled over a larger pool: the
    named rows hold what the plain version writes (2e-4), every other row
    is bitwise unchanged, write=False leaves the whole pool bitwise
    unchanged, and y is the same with and without write."""
    b, L, H, P, G, N = shape
    gen = torch.Generator(device=cuda).manual_seed(7 + sum(shape))
    x, dt, A, B, C, _ = _ssd_inputs(gen, b, L, H, P, G, N, dtype, cuda)
    rows = 2 * b + 3
    pool = 0.1 * torch.randn((rows, H, P, N), generator=gen, device=cuda)
    perm = torch.randperm(rows, generator=gen, device=cuda)
    idx = perm[:b].to(torch.int32)
    others = perm[b:].long()
    p = _ssd_plans(b, L, H, P, N, dtype, path)[0]
    ref = pool.clone()
    yp = ssd.ssd_slots_plain(x.float(), dt, A, B.float(), C.float(), 128,
                             ref, idx)
    got = {}
    for write in (False, True):
        st = pool.clone()
        got[write] = ssd.launch_plan(x, dt, A, B, C, st,
                                     st if write else None, idx, p)
        torch.cuda.synchronize()
        if write:
            _ssd_close(got[write], st[idx.long()], yp, ref[idx.long()],
                       dtype)
            assert torch.equal(st[others], pool[others])
        else:
            assert torch.equal(st, pool)
    assert torch.equal(got[False], got[True])
    if p == ssd.plan_for(x, B):           # the wrapper the mixer calls
        st = pool.clone()
        assert torch.equal(ssd.ssd_slots(x, dt, A, B, C, 128, st, idx),
                           got[True])


@pytest.mark.gpu
@pytest.mark.parametrize("path", ["rec", "chunk"])
def test_ssd_strided_views_bitwise_on_both_paths(cuda, path):
    """x, B and C given as views of one wider tensor (the mixer's layout)
    give the contiguous inputs' result bit for bit on either path, f32 and
    bf16."""
    b, L, H, P, G, N = 2, 40, 4, 16, 2, 8
    for dtype in (torch.float32, torch.bfloat16):
        gen = torch.Generator(device=cuda).manual_seed(3)
        x, dt, A, B, C, s0 = _ssd_inputs(gen, b, L, H, P, G, N, dtype, cuda)
        wide = torch.cat([x.reshape(b, L, H * P), B.reshape(b, L, G * N),
                          C.reshape(b, L, G * N)], dim=-1)
        xv = wide[..., : H * P].reshape(b, L, H, P)
        Bv = wide[..., H * P: H * P + G * N].reshape(b, L, G, N)
        Cv = wide[..., H * P + G * N:].reshape(b, L, G, N)
        assert not xv.is_contiguous()
        p = _ssd_plans(b, L, H, P, N, dtype, path)[0]
        s1, s2 = torch.empty_like(s0), torch.empty_like(s0)
        y1 = ssd.launch_plan(x, dt, A, B, C, s0, s1, None, p)
        y2 = ssd.launch_plan(xv, dt, A, Bv, Cv, s0, s2, None, p)
        assert torch.equal(y1, y2) and torch.equal(s1, s2)


@pytest.mark.gpu
def test_ssd_smem_matches_compiled_kernels(cuda):
    """Both paths, at every supported N, dtype, state slice and (chunk
    path) block size, ask for the dynamic shared memory their plan counts
    (`chunk_smem`, `rec_smem`),
    and that with the compiled kernel's static shared memory fits the
    device's limit per block, SMEM_LIMIT."""
    lib = ssd.LIBRARY.load()
    for N in ssd.SUPPORTED_N:
        for dtype in (torch.float32, torch.bfloat16):
            esize = 2 if dtype == torch.bfloat16 else 4
            for P in (8, 64, 128):
                cases = [(0, ssd.rec_plan(P, N))]
                widest = ssd.slice_max(P, N)
                for q in (16, 32, 64):
                    for pb in (8, 16, 32, 64, 128):
                        smem = ssd.chunk_smem(q, N, pb, esize)
                        if pb <= widest and P % pb == 0 \
                                and smem <= SMEM_LIMIT:
                            cases += [(1, ssd.Plan("chunk", pb, q, threads,
                                                   smem))
                                      for threads in (256, 512)]
                for chunk_path, p in cases:
                    dynamic, static, limit = _smem(
                        lib.ssd_smem, chunk_path, p.threads, p.q, N, p.pb,
                        esize == 2)
                    case = (N, dtype, P, p, dynamic, static)
                    assert limit == SMEM_LIMIT
                    assert dynamic == p.smem, case
                    assert dynamic + static <= limit, case


@pytest.mark.gpu
def test_ssd_wrapper_raises_instead_of_falling_back(cuda):
    """A CUDA tensor the kernel does not take raises; the plain version
    is never run in its place."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    x, dt, A, B, C, s0 = _ssd_inputs(gen, 1, 8, 2, 16, 1, 8, torch.float32,
                                     cuda)
    before = ssd.LAUNCHES
    with pytest.raises(ValueError, match="x dtype"):
        ssd.ssd(x.half(), dt, A, B, C, 16)
    with pytest.raises(ValueError, match="share a dtype"):
        ssd.ssd(x, dt, A, B.bfloat16(), C.bfloat16(), 16)
    with pytest.raises(ValueError, match="dt is on cpu"):
        ssd.ssd(x, dt.cpu(), A, B, C, 16)
    with pytest.raises(ValueError, match="groups"):
        three = torch.zeros((1, 8, 3, 8), device=cuda)
        ssd.ssd(x, dt, A, three, three, 16)
    big = torch.zeros((1, 4, 1, 256), device=cuda)
    wide = torch.zeros((1, 4, 1, 512), device=cuda)
    with pytest.raises(ValueError, match="is not supported"):
        ssd.ssd(big, dt[:, :4, :1].contiguous(), A[:1].contiguous(), wide,
                wide, 16)
    with pytest.raises(ValueError, match="multiple of 8"):
        ssd.ssd(x[..., :12], dt, A, B, C, 16)
    pool = torch.zeros((4, 2, 16, 8), device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        ssd.ssd_slots(x, dt, A, B, C, 16, pool.transpose(2, 3).contiguous()
                      .transpose(2, 3))
    assert ssd.LAUNCHES == before
    ssd.ssd(x, dt, A, B, C, 16)
    assert ssd.LAUNCHES == before + 1


_OUTSIDE_SLOT = """
import torch
from repro_torch.kernels.ssd_scan import ops as ssd
dev = torch.device("cuda")
x = torch.randn((1, 4, 2, 16), device=dev)
dt = torch.full((1, 4, 2), 0.1, device=dev)
A = -torch.ones(2, device=dev)
B = torch.randn((1, 4, 1, 8), device=dev)
pool = torch.zeros((4, 2, 16, 8), device=dev)
for slot in (3, 4):
    ssd.ssd_slots(x, dt, A, B, B, 16, pool,
                  torch.tensor([slot], dtype=torch.int32, device=dev))
    torch.cuda.synchronize()
    print("slot", slot, "ran", flush=True)
"""


@pytest.mark.gpu
def test_ssd_slots_refuses_unaligned_state_and_stops_on_outside_slot(cuda):
    """A state whose start is not 16-byte aligned is refused before any
    launch (the recurrence moves its rows as 16-byte vectors); a slot
    outside the state stops the kernel with a CUDA error instead of
    reading and writing past the pool (in a process of its own: the
    error ends that process's CUDA context)."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    x, dt, A, B, C, _ = _ssd_inputs(gen, 1, 4, 2, 16, 1, 8, torch.float32,
                                    cuda)
    flat = torch.zeros(4 * 2 * 16 * 8 + 1, device=cuda)
    shifted = flat[1:].view(4, 2, 16, 8)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16 == 4
    before = ssd.LAUNCHES
    with pytest.raises(ValueError, match="16-byte aligned"):
        ssd.ssd_slots(x, dt, A, B, C, 16, shifted)
    assert ssd.LAUNCHES == before
    src = Path(ssd.__file__).resolve().parents[3]
    run = subprocess.run([sys.executable, "-c", _OUTSIDE_SLOT],
                         capture_output=True, text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": str(src)})
    assert "slot 3 ran" in run.stdout, run.stderr
    assert "slot 4 ran" not in run.stdout
    assert run.returncode != 0 and "CUDA error" in run.stderr, run.stderr


@pytest.mark.gpu
@pytest.mark.parametrize("family", ["ssm", "hybrid"])
@pytest.mark.parametrize("paged", [False, True])
def test_cuda_engine_ssm_and_hybrid_are_greedy_exact(cuda, family, paged):
    """Tiny float32 SSM and hybrid targets served by the cosine engine
    (chain-only) on the card: every SSM layer of every forward launches
    the SSD kernel, and the committed streams are the greedy ones."""
    kw = dict(n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
              d_ff=256, vocab=300, tie_embeddings=True, dtype="float32",
              ssm=SSMConfig(d_state=32, head_dim=32, chunk_size=32))
    if family == "ssm":
        tcfg = ModelConfig(name="s", family="ssm", **kw)
    else:
        tcfg = ModelConfig(name="h", family="hybrid", hybrid_attn_period=2,
                           hybrid_attn_offset=1, **kw)
    dcfg = tcfg.with_overrides(name="d", n_layers=1)
    tp = M.init_params(tcfg, 0)
    cos = CoSineConfig(n_drafters=2, paged_pool=paged, page_size=16,
                       pool_pages=4)
    eng = SpeculativeEngine((tcfg, tp), [(dcfg, M.init_params(dcfg, 1), "a"),
                                         (tcfg, tp, "b")],
                            cos, max_len=128, seed=0)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, 300, n).tolist() for n in (5, 17, 40)]
    reqs = [eng.submit(p, max_new_tokens=16) for p in prompts]
    ssd.LAUNCHES = fa.LAUNCHES = pa.LAUNCHES = 0
    stats = eng.run()
    assert ssd.LAUNCHES > 0 and stats.mean_acceptance > 1.0
    assert (fa.LAUNCHES + pa.LAUNCHES > 0) == (family == "hybrid")
    for r, p in zip(reqs, prompts):
        assert list(map(int, r.generated)) == _greedy(tcfg, tp, p, 16, cuda)


# ---------------------------------------------------------------------
# the wall-clock backend: a verification server on its own stream
# ---------------------------------------------------------------------

def _async_case(family):
    kw = dict(n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
              d_ff=256, vocab=300, tie_embeddings=True, dtype="float32")
    if family == "ssm":
        tcfg = ModelConfig(name="s", family="ssm",
                           ssm=SSMConfig(d_state=32, head_dim=32,
                                         chunk_size=32), **kw)
    else:
        tcfg = ModelConfig(name="t", family="dense", **kw)
    dcfg = tcfg.with_overrides(name="d", n_layers=1)
    tp = M.init_params(tcfg, 0)
    drafters = [(dcfg, M.init_params(dcfg, 1), "a"), (tcfg, tp, "b")]
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, 300, n).tolist() for n in (5, 17, 40)]
    return tcfg, tp, drafters, prompts


def _serve_streams(tcfg, tp, drafters, prompts, backend, watch=None):
    eng = SpeculativeEngine((tcfg, tp), drafters, CoSineConfig(n_drafters=2),
                            max_len=128, seed=0, backend=backend)
    if watch is not None:
        watch(eng)
    reqs = [eng.submit(p, max_new_tokens=16) for p in prompts]
    try:
        stats = eng.run()
    finally:
        eng.backend.shutdown()
    return [list(map(int, r.generated)) for r in reqs], stats, eng


@pytest.mark.gpu
@pytest.mark.parametrize("family", ["dense", "ssm"])
def test_async_backend_commits_the_simulated_streams(cuda, family):
    """The wall-clock backend on the card (target on the server's stream,
    drafters on the engine's, float32 tiny models) commits what the
    simulated backend commits, which is the target's greedy stream; its
    kernels launched."""
    tcfg, tp, drafters, prompts = _async_case(family)
    sim, _, _ = _serve_streams(tcfg, tp, drafters, prompts, None)
    fa.LAUNCHES = ssd.LAUNCHES = 0
    got, stats, eng = _serve_streams(tcfg, tp, drafters, prompts, "async")
    assert (ssd.LAUNCHES if family == "ssm" else fa.LAUNCHES) > 0
    assert got == sim
    for s, p in zip(got, prompts):
        assert s == _greedy(tcfg, tp, p, 16, cuda)
    assert stats.records and all(r.verify_ms > 0 for r in stats.records)


@pytest.mark.gpu
def test_async_backend_streams_are_distinct_and_not_default(cuda):
    """Target forwards run on the server thread under the backend's
    target stream, drafter forwards on the engine thread under its draft
    stream: two distinct streams, neither the legacy default stream."""
    import threading

    tcfg, tp, drafters, prompts = _async_case("dense")
    seen = set()

    def watch(eng):
        b = eng.backend
        for runner, side in [(b.target, "target")] + [
                (d, "drafter") for d in b.drafters]:
            for name in ("verify_device", "extend_committed",
                         "prefill_requests", "prefill_request",
                         "extend_snapshot", "decode"):
                orig = getattr(runner, name)

                def rec(*a, orig=orig, side=side, **kw):
                    seen.add((side, threading.current_thread().name,
                              torch.cuda.current_stream().cuda_stream))
                    return orig(*a, **kw)

                setattr(runner, name, rec)

    _, _, eng = _serve_streams(tcfg, tp, drafters, prompts, "async", watch)
    b = eng.backend
    ts, ds = b.target_stream.cuda_stream, b.draft_stream.cuda_stream
    default = torch.cuda.default_stream().cuda_stream
    assert ts != ds and default not in (ts, ds)
    assert {s for side, _, s in seen if side == "target"} == {ts}
    assert {s for side, _, s in seen if side == "drafter"} == {ds}
    assert {side for side, _, _ in seen} == {"target", "drafter"}
    assert all(t.startswith("verify-server")
               for side, t, _ in seen if side == "target")
    assert all(t == threading.current_thread().name
               for side, t, _ in seen if side == "drafter")


@pytest.mark.gpu
def test_launch_counters_exact_under_two_threads(cuda):
    """Two threads, each on its own stream, launch each kernel N times at
    once (with a short switch interval): every counter rises by exactly
    2 N."""
    import sys
    import threading

    gen = torch.Generator(device=cuda).manual_seed(0)
    q = torch.randn((2, 3, 2, 2, 64), generator=gen, device=cuda)
    k = torch.randn((4, 64, 2, 64), generator=gen, device=cuda)
    kpos = torch.arange(64, dtype=torch.int32, device=cuda).repeat(4, 1)
    qpos = torch.full((2, 3), 63, dtype=torch.int32, device=cuda)
    slot = torch.tensor([1, 3], dtype=torch.int32, device=cuda)
    pool = torch.randn((4, 16, 2, 64), generator=gen, device=cuda)
    ppos = torch.full((4, 16), -1, dtype=torch.int32, device=cuda)
    ppos[2] = torch.arange(16, dtype=torch.int32, device=cuda)
    ppos[3] = ppos[2] + 16
    tbl = torch.tensor([[2, 3], [2, 3]], dtype=torch.int32, device=cuda)
    qp = torch.full((2, 3), 31, dtype=torch.int32, device=cuda)
    x8, w8, sc = _int8_case(cuda, "splitk")
    sx = _ssd_inputs(gen, 1, 8, 2, 16, 1, 8, torch.float32, cuda)[:5]
    calls = {
        "fa": (fa, lambda: fa.attend_partial(q, k, k, qpos, kpos, scale=0.1,
                                             slot_idx=slot)),
        "pa": (pa, lambda: pa.paged_attend_partial(q, pool, pool, qp, ppos,
                                                   tbl, scale=0.1)),
        "ig": (ig, lambda: ig.int8_gemv(x8, w8, sc)),
        "ssd": (ssd, lambda: ssd.ssd(*sx, 16)),
    }
    for _, fn in calls.values():
        fn()                                   # build and load first
    torch.cuda.synchronize()
    N = 200
    before = {name: mod.LAUNCHES for name, (mod, _) in calls.items()}
    errors = []

    def worker():
        try:
            with torch.cuda.stream(torch.cuda.Stream()):
                for _ in range(N):
                    for _, fn in calls.values():
                        fn()
                torch.cuda.current_stream().synchronize()
        except Exception as e:           # reported by the main thread
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker) for _ in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
    finally:
        sys.setswitchinterval(interval)
    assert not errors and not any(t.is_alive() for t in threads)
    for name, (mod, _) in calls.items():
        assert mod.LAUNCHES == before[name] + 2 * N, name


# ---------------------------------------------------------------------
# training: the gradient through kernel 1, and the wrappers' refusals


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("T,G", [(4, 2), (12, 2)])
def test_attention_grad_through_kernel1(cuda, T, G, D, dtype):
    """`fa.attention` (kernel 1's forward, the tensor-op backward) against
    autograd through the plain version on the card, self-contained
    causal attention at R = T x G = 8 (the GQA form) and 24 (from R_MMA:
    the many-row form at D 64 and 128), with a window and non-causal.
    The forward is one launch of kernel 1; f32 within 1e-4 of each
    gradient's largest value (f32 sums in another order), bf16 within
    2e-2 (one bf16 step, 2^-8, where the two f32 values round apart)."""
    gen = torch.Generator(device=cuda).manual_seed(D + T)
    B, H, S = 2, 2, T
    pos = torch.arange(T, dtype=torch.int32, device=cuda).expand(B, T)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    for kw in (dict(), dict(window=3), dict(causal=False)):
        q = torch.randn((B, T, H, G, D), generator=gen, device=cuda).to(
            dtype).requires_grad_()
        k = torch.randn((B, S, H, D), generator=gen, device=cuda).to(
            dtype).requires_grad_()
        v = torch.randn((B, S, H, D), generator=gen, device=cuda).to(
            dtype).requires_grad_()
        d_out = torch.randn((B, T, H, G, D), generator=gen,
                            device=cuda).to(dtype)
        before, many = fa.LAUNCHES, fa.LAUNCHES_MANY_ROWS
        out = fa.attention(q, k, v, pos, pos, scale=D ** -0.5, **kw)
        assert fa.LAUNCHES == before + 1
        assert fa.LAUNCHES_MANY_ROWS - many == int(
            T * G >= fa.R_MMA and D in fa.MMA_HEADS)
        got = torch.autograd.grad((out.float() * d_out).sum(), (q, k, v))
        want_out = fa.finalize(fa.attend_partial_plain(
            q, k, v, pos, pos, scale=D ** -0.5, **kw)).to(dtype)
        want = torch.autograd.grad((want_out.float() * d_out).sum(),
                                   (q, k, v))
        assert fa.LAUNCHES == before + 1       # the backward launches none
        torch.testing.assert_close(out.float(), want_out.float(),
                                   rtol=tol, atol=tol)
        for a, b in zip(got, want):
            assert a.dtype == dtype
            err = float((a.float() - b.float()).abs().max())
            assert err <= tol * float(b.float().abs().max()), err


@pytest.mark.gpu
def test_lm_loss_grads_through_kernel1(cuda):
    """A tiny dense model's loss and every gradient leaf with kernel 1 in
    each attention forward against the same step through the plain
    version (phase P's check at f32, its tolerance)."""
    import importlib.util
    from repro_torch.models import attention as attn
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    cfg = ModelConfig(name="t", family="dense", n_layers=2, d_model=256,
                      n_heads=8, n_kv_heads=2, head_dim=32, d_ff=512,
                      vocab=96, tie_embeddings=True, dtype="float32",
                      qkv_bias=True)
    params = M.init_params(cfg, 0, device=cuda)
    tokens = torch.randint(0, 96, (2, 40), device=cuda,
                           generator=torch.Generator(device=cuda)
                           .manual_seed(1))
    loss_k, loss_p, err, n, n_ssd = smoke.grad_check(torch, M, attn, fa,
                                                     cfg, params, tokens)
    assert (n, n_ssd) == (cfg.n_layers, 0)
    assert abs(loss_k - loss_p) <= 1e-5 * loss_p
    metric, tol = smoke.GRAD_TOL["float32"]
    assert err[metric] <= tol


@pytest.mark.gpu
def test_wrappers_refuse_a_gradient(cuda):
    """On CUDA tensors no wrapper returns an output without the gradient
    an input asks for: each raises (naming what has no gradient), and
    launches nothing; under torch.no_grad, or with inputs that ask for
    none, each launches as before. The SSD scan refuses only a call that
    carries a state in place; with state=None it differentiates through
    `scan`, its forward one launch of the kernel."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    B, T, H, G, D, S, ps = 2, 3, 2, 2, 64, 64, 16
    q = torch.randn((B, T, H, G, D), generator=gen, device=cuda)
    k = torch.randn((B, S, H, D), generator=gen, device=cuda)
    qpos = torch.full((B, T), S - 1, dtype=torch.int32, device=cuda)
    kpos = torch.arange(S, dtype=torch.int32, device=cuda).repeat(B, 1)
    P = 1 + B * S // ps
    kp = torch.randn((P, ps, H, D), generator=gen, device=cuda)
    pos = torch.full((P, ps), -1, dtype=torch.int32, device=cuda)
    pos[1:] = torch.arange(S, dtype=torch.int32, device=cuda).view(
        -1, ps).repeat(B, 1)
    tbl = torch.arange(1, P, dtype=torch.int32, device=cuda).view(B, -1)
    x = torch.randn((5, 96), generator=gen, device=cuda)
    w8 = torch.randint(-127, 128, (96, 40), dtype=torch.int8, device=cuda,
                       generator=gen)
    sc = torch.rand((1, 40), generator=gen, device=cuda)
    sx, dt, A, Bm, Cm, s0 = _ssd_inputs(gen, 1, 8, 4, 16, 1, 16,
                                        torch.float32, cuda)
    calls = {
        "flash-attention": (fa, lambda q: fa.attend_partial(
            q, k, k, qpos, kpos, scale=D ** -0.5)),
        "paged-attention": (pa, lambda q: pa.paged_attend_partial(
            q, kp, kp, qpos, pos, tbl, scale=D ** -0.5)),
        "int8 GEMV": (ig, lambda x: ig.int8_gemv(x, w8, sc)),
        "SSD scan": (ssd, lambda x: ssd.ssd_slots(x, dt, A, Bm, Cm, 16,
                                                  s0.clone())),
    }
    inputs = {"flash-attention": q, "paged-attention": q, "int8 GEMV": x,
              "SSD scan": sx}
    for name, (mod, fn) in calls.items():
        t = inputs[name].clone().requires_grad_()
        before = mod.LAUNCHES
        with pytest.raises(RuntimeError, match="gradient") as e:
            fn(t)
        assert name in str(e.value)
        if name == "SSD scan":
            assert "carries a state" in str(e.value)
        assert mod.LAUNCHES == before
        with torch.no_grad():
            fn(t)
        fn(t.detach())
        assert mod.LAUNCHES == before + 2
    t = sx.clone().requires_grad_()
    before = ssd.LAUNCHES
    y, final = ssd.ssd(t, dt, A, Bm, Cm, 16)
    y2 = ssd.ssd_slots(t, dt, A, Bm, Cm, 16, None)
    assert ssd.LAUNCHES == before + 2
    assert y.requires_grad and final.requires_grad and y2.requires_grad
    assert torch.equal(y, y2)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 300, 24, 64, 1, 128),
                                   (2, 300, 128, 64, 1, 16)])
def test_ssd_scan_gradient_on_the_kernel(cuda, shape, dtype):
    """`SSDScanFunction` at mamba2-130m's and jamba's SSD widths (300
    tokens: the chunk path, a ragged last chunk of 128), f32 and bf16:
    its forward is one kernel launch whose y and final state are `ssd`'s
    bits; its gradients are `ssd_grad`'s bits and within 2e-4 of each
    leaf's largest value of autograd through the plain version (bf16 x,
    B and C: plus one bf16 step of the element, each side rounding its
    f32 gradient once)."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    ins = list(_ssd_inputs(gen, *shape, dtype, cuda))
    dy = torch.randn((shape[0], shape[1], shape[2], shape[3]),
                     generator=gen, device=cuda).to(dtype)
    dfinal = torch.randn_like(ins[5])
    chunk = 128
    with torch.no_grad():
        y_k, f_k = ssd.ssd(*ins[:5], chunk, ins[5])
    leaves = [t.clone().requires_grad_() for t in ins]
    before = ssd.LAUNCHES
    y, final = ssd.scan(*leaves[:5], chunk, leaves[5])
    assert ssd.LAUNCHES == before + 1
    assert torch.equal(y, y_k) and torch.equal(final, f_k)
    got = torch.autograd.grad((y.float() * dy.float()).sum()
                              + (final * dfinal).sum(), leaves)
    want = ssd.ssd_grad(*ins[:5], chunk, ins[5], dy, dfinal)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    plain = [t.clone().requires_grad_() for t in ins]
    yp, fp = ssd.ssd_chunked(*plain[:5], chunk, plain[5])
    ref = torch.autograd.grad((yp.float() * dy.float()).sum()
                              + (fp * dfinal).sum(), plain)
    assert ssd.LAUNCHES == before + 1
    for i, (g, r) in enumerate(zip(got, ref)):
        g, r = g.float(), r.float()
        err = (g - r).abs()
        if dtype == torch.bfloat16 and i in (0, 3, 4):
            err = err - r.abs() * 2.0 ** -7
        assert float(err.max()) <= 2e-4 * float(r.abs().max()), i


@pytest.mark.gpu
def test_profiler_events_are_prof_events_on_the_card(cuda):
    """`chip_smoke.py::profiler_events` against `prof.events()` over a
    window with device kernels, copies and a named host range: the same
    names, device types, threads, time ranges and kernels linked to each
    host operation (so the windows' device shares, MoE attribution and
    threads read the same numbers)."""
    import importlib.util

    from torch.profiler import ProfilerActivity, profile, record_function
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    x = torch.randn((64, 64), device=cuda)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(20):
            with record_function(smoke.MOE_RANGE):
                y = (x @ x).relu().sum()
            float(y)
            x = x.to(torch.bfloat16).float()
        torch.cuda.synchronize()

    def fields(events):
        return sorted((e.name, str(e.device_type), e.thread,
                       e.time_range.start, e.time_range.end,
                       tuple(sorted(k.duration for k in e.kernels)))
                      for e in events)

    got = smoke.profiler_events(torch, prof)
    want = prof.events()
    assert any(e.device_type == torch.autograd.DeviceType.CUDA for e in got)
    assert sum(len(e.kernels) for e in got) >= 60
    assert fields(got) == fields(want)
    assert smoke.range_device_us(got, smoke.MOE_RANGE) == \
        smoke.range_device_us(want, smoke.MOE_RANGE)
