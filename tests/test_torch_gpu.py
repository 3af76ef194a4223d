"""Tests of the PyTorch port that need an NVIDIA GPU (marked `gpu`).

The CUDA kernel has no CPU mode, so these skip on a host without a card.
This file imports neither JAX nor the JAX package, so it also runs where
only PyTorch is installed; there, run it without the repository's
conftest (which imports the JAX package):

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest
import torch

from repro_torch.config import CoSineConfig, ModelConfig
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.models import model as M
from repro_torch.serving.engine import SpeculativeEngine


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D,G,T", [(64, 7, 1), (128, 1, 10), (32, 2, 40),
                                   (16, 4, 3)])
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
def test_cuda_engine_is_greedy_exact(cuda):
    """The cosine engine on the card (random drafter + perfect drafter,
    float32 tiny models) commits the target's greedy stream, and every
    attention of the run launched the kernel."""
    tcfg = ModelConfig(name="t", family="dense", n_layers=2, d_model=128,
                       n_heads=4, n_kv_heads=2, head_dim=32, d_ff=256,
                       vocab=300, tie_embeddings=True, dtype="float32")
    dcfg = tcfg.with_overrides(name="d", n_layers=1, n_heads=2, head_dim=64)
    tp = M.init_params(tcfg, 0)
    eng = SpeculativeEngine((tcfg, tp), [(dcfg, M.init_params(dcfg, 1), "a"),
                                         (tcfg, tp, "b")],
                            CoSineConfig(n_drafters=2), max_len=128, seed=0)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, 300, n).tolist() for n in (5, 17, 40)]
    reqs = [eng.submit(p, max_new_tokens=16) for p in prompts]
    fa.LAUNCHES = 0
    stats = eng.run()
    assert fa.LAUNCHES > 0 and stats.mean_acceptance > 1.0
    for r, p in zip(reqs, prompts):
        cache = M.init_cache(tcfg, 1, 128, dtype=torch.float32)
        lg, cache, _ = M.prefill(tp, tcfg, torch.tensor([p], device=cuda),
                                 cache)
        ref = []
        for _ in range(16):
            ref.append(int(torch.argmax(lg[0, -1, : tcfg.vocab])))
            lg, cache, _ = M.decode_step(
                tp, tcfg, torch.tensor([[ref[-1]]], device=cuda), cache)
        assert list(map(int, r.generated)) == ref
