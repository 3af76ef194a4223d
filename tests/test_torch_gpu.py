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
                                   (16, 4, 3), (128, 4, 6)])
def test_cuda_kernel_matches_plain(cuda, D, G, T, dtype):
    """The Hopper kernel against its plain version: a slot pool read in
    place (with a repeated scratch row), plain causal, a mask, a window
    and a fully masked row. Same f32 arithmetic in another summation
    order, so rtol = atol = 1e-4."""
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
    """Both attention kernels, at every head dim and dtype pair, ask for
    the dynamic shared memory `kernel_smem` counts, and that with the
    static shared memory of the compiled kernel fits SMEM_LIMIT, the
    device's limit per block."""
    for f in (fa.LIBRARY.load().fa_smem, pa.LIBRARY.load().paged_smem):
        for D in fa.SUPPORTED_HEAD_DIMS:
            for q_bf16 in (0, 1):
                for kv_bf16 in (0, 1):
                    dynamic, static, limit = _smem(f, D, q_bf16, kv_bf16)
                    case = (f.__name__, D, q_bf16, kv_bf16, dynamic, static)
                    assert limit == SMEM_LIMIT
                    assert dynamic == fa.kernel_smem(
                        D, 2 if kv_bf16 else 4), case
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
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,G,H", [(1, 7, 2), (10, 1, 20), (6, 4, 8)])
def test_kernel1_bits_do_not_depend_on_capacity(cuda, T, G, H, dtype):
    """A slot pool of 1024 keys and a 128-key copy of the same keys give
    kernel 1 the same bits: the span of the key split comes from the
    grid, and blocks past the live keys merge in as exact no-ops. The
    paged pool's streams equal the resident pool's by this (phase C)."""
    gen = torch.Generator(device=cuda).manual_seed(T * G)
    B, D, S = 4, 64, 1024
    q = torch.randn((B, T, H, G, D), generator=gen, device=cuda)
    k = torch.randn((B, S, H, D), generator=gen, device=cuda).to(dtype)
    v = torch.randn((B, S, H, D), generator=gen, device=cuda).to(dtype)
    lens = [100, 128 - T, 1, 60]
    kpos = torch.full((B, S), -1, dtype=torch.int32, device=cuda)
    for b, n in enumerate(lens):
        kpos[b, :n + T] = torch.arange(n + T, dtype=torch.int32, device=cuda)
    qpos = torch.tensor([[n + t for t in range(T)] for n in lens],
                        dtype=torch.int32, device=cuda)
    full = fa.attend_partial(q, k, v, qpos, kpos, scale=D ** -0.5)
    short = fa.attend_partial(q, k[:, :128].contiguous(),
                              v[:, :128].contiguous(), qpos,
                              kpos[:, :128].contiguous(), scale=D ** -0.5)
    assert fa.plan_splits(B, H, T * G, S)[0] > fa.plan_splits(
        B, H, T * G, 128)[0]
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
                                   (6, 4, 128)])
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
