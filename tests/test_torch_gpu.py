"""Tests of the PyTorch port that need an NVIDIA GPU (marked `gpu`).

The CUDA kernels have no CPU mode, so these skip on a host without a card.
This file imports neither JAX nor the JAX package, so it also runs where
only PyTorch is installed; there, run it without the repository's
conftest (which imports the JAX package):

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest
import torch

from repro_torch.config import CoSineConfig, ModelConfig, SSMConfig
from repro_torch.configs.drafters import int8_variant
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
@pytest.mark.parametrize("M_", [1, 4, 8, 64])
@pytest.mark.parametrize("K,N", [(896, 128), (100, 4864), (37, 13)])
def test_int8_gemv_matches_plain(cuda, M_, K, N, xdtype):
    """The int8 GEMV kernel against its plain version, for the dense
    (K, N) layout and the transposed (N, K) table, aligned and not. The
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
    wide = torch.zeros((1, 4, 1, 256), device=cuda)
    with pytest.raises(ValueError, match="does not fit"):
        ssd.ssd(big, dt[:, :4, :1].contiguous(), A[:1].contiguous(), wide,
                wide, 16)
    assert ssd.LAUNCHES == before
    ssd.ssd(x, dt, A, B, C, 16)
    assert ssd.LAUNCHES == before + 1


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
