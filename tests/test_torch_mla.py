"""MLA (DeepSeek-V3's absorbed multi-head latent attention) in the PyTorch
port against the JAX package, on the same numpy inputs.

* The plain latent form of the attention partials (Dk != Dv, one KV head,
  every query head folded into G) against the Pallas kernel
  `repro.kernels.common.flash_attention_partial` in interpret mode, within
  1e-5, with and without a tree mask, at the reference's tiny widths and
  at DeepSeek-V3's (Dk 576, Dv 512).
* `mla_attention` against the reference's within 1e-5 in every mode: no
  cache, prefill, decode, a tree verification (seg_mask, write=False)
  and token_mask padding; the latent cache rows equal the reference's.
* `apply` of a tiny DeepSeek-like model (MLA, dense layers 0-2, a MoE
  layer with a shared expert from layer 3, the MTP subtree) against
  `repro.models.model.apply` within 1e-4, with weights carried across by
  `params_from_numpy`; the port's own `init_params` builds the
  reference's tree.
* The runners: padded-chunk prefill and decode against the JAX runner;
  the paged pool bitwise equal to the resident pool and within 1e-4 of
  the JAX resident runner (never bitwise against the JAX paged path).
* A `cosine` engine on an MLA target commits the port's greedy stream and
  the JAX engine's, on the simulated backend and on `backend="async"`.
* kv_dtype="int8" with MLA raises ValueError at both cache constructors,
  as the reference does.
* V read out of K: `v_in_k` holds for K's first Dv columns of a slot
  pool, a page pool and a fresh segment, and for nothing else; every
  write mode (masked prefill, decode, commit, a seg_mask read that
  writes, page-pool growth, snapshots) keeps "v" equal to "k"[..., :Dv]
  bit for bit, so the served reads may pass that view as v.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _jax_fast_compile import fast_compile
from repro.config import CoSineConfig, MLAConfig, ModelConfig, MoEConfig
from repro.kernels.common import flash_attention_partial as jax_partial
from repro.models import attention as JA
from repro.models import model as JM
from repro.serving.engine import SpeculativeEngine as JaxEngine
from repro.serving.runner import ModelRunner as JaxRunner
from repro_torch import config as tconfig
from repro_torch.kernels.build import SMEM_LIMIT
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.models import attention as TA
from repro_torch.models import model as TM
from repro_torch.models.convert import params_from_numpy
from repro_torch.serving.engine import SpeculativeEngine
from repro_torch.serving.runner import (ModelRunner, PagedSlotCacheManager,
                                       SlotCacheManager)
from test_torch_paged import _drive


@pytest.fixture(scope="module", autouse=True)
def _fast_reference_compile():
    """The JAX package's programs compiled cheaply (`_jax_fast_compile`)."""
    with fast_compile():
        yield


MAX_LEN = 96
NEW = 10
TINY_MLA = MLAConfig(q_lora_rank=32, kv_lora_rank=32, qk_nope_head_dim=16,
                     qk_rope_head_dim=8, v_head_dim=16)


def _tiny_mla():
    """The reference's tiny MLA config (tests/test_runner_slots.py)."""
    return ModelConfig(name="tiny-mla", family="dense", attention="mla",
                       mla=TINY_MLA, n_layers=2, d_model=64, n_heads=4,
                       n_kv_heads=2, head_dim=16, d_ff=128, vocab=50,
                       tie_embeddings=True, dtype="float32")


def _tiny_deepseek():
    """DeepSeek-V3's structure at tiny widths: MLA in every layer, dense
    FFN in layers 0-2, routed experts with a shared expert from layer 3,
    an untied head and the MTP subtree."""
    return ModelConfig(name="tiny-deepseek", family="moe", attention="mla",
                       mla=TINY_MLA, n_layers=4, d_model=64, n_heads=4,
                       n_kv_heads=4, head_dim=16, d_ff=96, vocab=60,
                       moe=MoEConfig(n_routed=8, top_k=2, d_ff=32, n_shared=1,
                                     layer_offset=3, layer_period=1),
                       mtp=True, dtype="float32")


def _tcfg(cfg):
    cls = (tconfig.CoSineConfig if isinstance(cfg, CoSineConfig)
           else tconfig.ModelConfig)
    kw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    if isinstance(cfg, ModelConfig):
        for name, sub in (("mla", tconfig.MLAConfig),
                          ("moe", tconfig.MoEConfig)):
            if kw.get(name) is not None:
                kw[name] = sub(**dataclasses.asdict(kw[name]))
    return cls(**kw)


def _np(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _close(t, j, tol):
    np.testing.assert_allclose(
        t.detach().numpy() if torch.is_tensor(t) else np.asarray(t),
        np.asarray(j), rtol=tol, atol=tol)


def _models(cfg, seed=0):
    tree = jax.tree.map(np.asarray, JM.init_params(jax.random.PRNGKey(seed),
                                                   cfg))
    tcfg = _tcfg(cfg)
    return cfg, tcfg, tree, params_from_numpy(tree, tcfg, "cpu")


@pytest.fixture(scope="module")
def mla():
    return _models(_tiny_mla())


@pytest.fixture(scope="module")
def deepseek():
    return _models(_tiny_deepseek(), seed=3)


# -------------------------------------------- the plain latent form

@pytest.mark.parametrize("Dk,Dv,G,T,S", [(40, 32, 4, 3, 70),
                                         (576, 512, 8, 2, 40)])
@pytest.mark.parametrize("with_mask", [False, True])
def test_plain_latent_form_matches_pallas_interpret(Dk, Dv, G, T, S,
                                                    with_mask):
    """The plain version of kernel 1's latent form, in the model's layout
    (B, T, 1, G, Dk) with the kernel's 16-key tiles, against the Pallas
    kernel's (B, Hkv, R, D) contract with rows r = t G + g: partials and
    the merged output within 1e-5; an empty request gives l = 0."""
    B = 2
    q = _np(1, (B, T, 1, G, Dk))
    k, v = _np(2, (B, S, 1, Dk)), _np(3, (B, S, 1, Dv))
    kpos = np.broadcast_to(np.where(np.arange(S) < S - 4, np.arange(S), -1),
                           (B, S)).astype(np.int32).copy()
    kpos[1] = -1
    qpos = np.broadcast_to(S - 4 - T + np.arange(T), (B, T)).astype(np.int32)
    mask = (np.random.default_rng(4).random((B, T, S)) < 0.6
            if with_mask else None)
    scale = Dk ** -0.5
    m_t, l_t, acc_t = fa.attend_partial_plain(
        torch.tensor(q), torch.tensor(k), torch.tensor(v), torch.tensor(qpos),
        torch.tensor(kpos), scale=scale,
        mask=None if mask is None else torch.tensor(mask),
        block=fa.key_tile(Dk, Dv))
    R = T * G
    acc_j, m_j, l_j = jax_partial(
        jnp.asarray(q.reshape(B, R, 1, Dk).transpose(0, 2, 1, 3)),
        jnp.asarray(k.transpose(0, 2, 1, 3)),
        jnp.asarray(v.transpose(0, 2, 1, 3)),
        jnp.asarray(np.repeat(qpos, G, axis=1)), jnp.asarray(kpos),
        scale=scale, mask=None if mask is None
        else jnp.asarray(np.repeat(mask, G, axis=1)),
        block_q=8, block_k=16, interpret=True)
    _close(acc_t.reshape(B, R, Dv), np.asarray(acc_j)[:, 0], 1e-5)
    _close(m_t.reshape(B, R), np.asarray(m_j)[:, 0], 1e-5)
    _close(l_t.reshape(B, R), np.asarray(l_j)[:, 0], 1e-5)
    assert float(l_t[1].abs().max()) == 0.0
    _close(fa.finalize((m_t, l_t, acc_t)).reshape(B, R, Dv),
           np.asarray(acc_j)[:, 0] / np.where(
               np.asarray(l_j) == 0, 1, np.asarray(l_j))[:, 0, :, None],
           1e-5)


def test_latent_tiling_and_smem():
    """The latent form's key tile (16) and row tile (64) come from one
    place for the plain version, the split plan and the split ranges
    alike; its clusters stay portable; a block's 64 rows share each key
    tile (2, 20 and 12 row tiles a request at decode, the T = 10 cache
    pass and the T = 6 commit, against 8, 80 and 48 for 16-row tiles);
    its shared memory (q in its dtype, two 16-key tile buffers, the two
    partial score tiles, at least the merge's 64 f32 rows and fold
    factors) fits a block of the H100 with room for the kernel's static
    part."""
    assert fa.key_tile(576, 512) == fa.key_tile(40, 32) == 16
    assert fa.key_tile(128, 128) == fa.KEY_TILE == 32
    assert fa.tiling(True) == (16, fa.LATENT_MAX_SPLIT, 64)
    assert fa.tiling(False) == (fa.KEY_TILE, fa.MAX_SPLIT, fa.ROW_TILE)
    for B, R in ((4, 128), (1, 128), (1, 512 * 128), (9, 6 * 128)):
        n, span = fa.plan_splits(B, 1, R, 1024, True)
        assert n <= fa.LATENT_MAX_SPLIT
        tiles = sorted(t for keys in fa.split_ranges(1024, n, span, True)
                       for lo, hi in keys for t in range(lo // 16, hi // 16))
        assert tiles == list(range(1024 // 16))
    # a T = 512 prefill: 1024 row tiles a request, no split; decode,
    # the cache pass and the commit of 4 requests split 8, 4 and 8 ways
    assert fa.plan_splits(1, 1, 512 * 128, 1024, True) == (1, 64)
    assert fa.plan_splits(4, 1, 128, 1024, True) == (8, 8)
    assert fa.plan_splits(4, 1, 10 * 128, 1024, True) == (4, 16)
    assert fa.plan_splits(4, 1, 6 * 128, 1024, True) == (8, 8)
    assert [-(-R // fa.tiling(True)[2]) for R in (128, 1280, 768)] == [
        2, 20, 12]
    # rows padded to 16 bytes past a multiple of 128 (conflict-free
    # fragment loads): 580 f32 or 584 bf16 values for Dk 576, 68 or 72
    # for the tiny pair's 40 (with bf16 K, padded to 48 first); f32 q
    # beside bf16 K is read in pairs, 32 bytes past: 584 f32 values
    q_f32, kv_f32, scores = 64 * 580 * 4, 2 * 16 * 580 * 4, 2 * 64 * 16 * 4
    assert fa.kernel_smem(576, 512, 4) == q_f32 + kv_f32 + scores == 230912
    assert fa.kernel_smem(576, 512, 4, 2) == 64 * 584 * 2 + kv_f32 + scores
    assert fa.kernel_smem(576, 512, 2, 4) == (64 * 584 * 4 + 2 * 16 * 584 * 2
                                              + scores)
    assert fa.kernel_smem(40, 32, 2, 4) == (64 * 72 * 4 + 2 * 16 * 72 * 2
                                            + scores)
    # bf16 q and K/V: the merge's (64, 512) f32 rows and the rows' fold
    # factors (two a rank of 8) are the larger part
    assert fa.kernel_smem(576, 512, 2, 2) == 64 * 512 * 4 + 64 * 8 * 8
    assert fa.kernel_smem(40, 32, 4) == 64 * 68 * 4 + 2 * 16 * 68 * 4 + scores
    # room beside it for the kernels' static part (1344 bytes, paged)
    for Dk, Dv in ((576, 512), (40, 32)):
        for kv in (2, 4):
            for qs in (2, 4):
                assert fa.kernel_smem(Dk, Dv, kv, qs) <= SMEM_LIMIT - 1344


# ------------------------------------------------- mla_attention

def _mla_params(cfg, tree):
    """Layer 0's MLA mixer params: the reference's (jnp) and the port's."""
    jp = jax.tree.map(lambda a: jnp.asarray(a[0]),
                      tree["stages"][0][0]["mixer"])
    return jp, {k: torch.tensor(np.asarray(a))
                for k, a in jp.items()}


def test_mla_attention_matches_reference_in_every_mode(mla):
    """No cache; prefill into an empty latent cache; decode; a tree
    verification (seg_mask, write=False, cache untouched); a chain whose
    suffix is padding (token_mask): outputs within 1e-5 and the cache
    leaves (latent rows, slot_pos) equal the reference's."""
    cfg, tcfg, tree, _ = mla
    jp, tp = _mla_params(cfg, tree)
    B, C = 2, 24
    jc = JA.make_mla_cache(B, C, cfg, jnp.float32)
    tc = TA.make_mla_cache(B, C, tcfg, torch.float32)
    assert tc["k"].shape == (B, C, 1, 40) and tc["v"].shape == (B, C, 1, 32)

    def both(x, pos, seed_mask=None, **kw):
        nonlocal jc
        jkw, tkw = dict(kw), dict(kw)
        for name in ("seg_mask", "token_mask"):
            if name in kw:
                jkw[name] = jnp.asarray(kw[name])
                tkw[name] = torch.tensor(kw[name])
        jo, jnew = JA.mla_attention(jp, cfg, jnp.asarray(x),
                                    jnp.asarray(pos), cache=jc, **jkw)
        to, tnew = TA.mla_attention(tp, tcfg, torch.tensor(x),
                                    torch.tensor(pos), cache=tc, **tkw)
        _close(to, jo, 1e-5)
        if kw.get("write", True):
            jc = jnew
            for key in ("k", "v", "slot_pos"):
                _close(tc[key], jc[key], 1e-5)
        else:
            assert tnew is None

    # no cache
    x = _np(10, (B, 7, cfg.d_model))
    pos = np.broadcast_to(np.arange(7, dtype=np.int32), (B, 7))
    jo, _ = JA.mla_attention(jp, cfg, jnp.asarray(x), jnp.asarray(pos))
    to, _ = TA.mla_attention(tp, tcfg, torch.tensor(x), torch.tensor(pos))
    _close(to, jo, 1e-5)
    # prefill, decode
    both(x, pos)
    both(_np(11, (B, 1, cfg.d_model)), np.full((B, 1), 7, np.int32))
    # tree verification: node 3 hangs off node 0, nothing written
    G = 4
    mask = np.tril(np.ones((G, G), bool))
    mask[3, 1:3] = False
    vpos = (8 + np.array([0, 1, 2, 1], np.int32))[None].repeat(B, 0)
    before = {k: t.clone() for k, t in tc.items()}
    both(_np(12, (B, G, cfg.d_model)), vpos,
         seg_mask=np.broadcast_to(mask, (B, G, G)).copy(), write=False)
    assert all(torch.equal(tc[k], before[k]) for k in tc)
    # a padded chain: the last two rows of request 1 are padding
    tm = np.ones((B, 5), bool)
    tm[1, 3:] = False
    both(_np(13, (B, 5, cfg.d_model)),
         (8 + np.arange(5, dtype=np.int32))[None].repeat(B, 0),
         token_mask=tm)
    assert int(tc["slot_pos"][1, 11]) == -1 and int(tc["slot_pos"][0, 12]) == 12


# ------------------------------------------------- V read out of K

def test_v_in_k_detects_k_prefix_views():
    """`v_in_k` is true for `k[..., :Dv]` of a slot pool, a page pool and
    a fresh latent segment (as `mla_attention` builds it), and false for
    a V of its own with the same values, for other views of K (another
    offset, fewer keys, another layout) and for another dtype."""
    R, rope = 32, 8
    for k in (torch.randn(5, 24, 1, R + rope),         # slot pool
              torch.randn(6, 16, 1, R + rope),         # page pool
              torch.cat([torch.randn(2, 7, R), torch.randn(2, 7, rope)],
                        dim=-1)[:, :, None, :]):       # fresh segment
        v = k[..., :R]
        assert fa.v_in_k(k, v)
        assert not fa.v_in_k(k, v.clone())
        assert not fa.v_in_k(k, k[..., 1: R + 1])
        assert not fa.v_in_k(k, k[:, 1:, ..., :R])
        assert not fa.v_in_k(k, k.transpose(0, 1)[..., :R])
        assert not fa.v_in_k(k.double(), k.double()[..., :R].float())
    # a GQA cache's own V is not read out of K
    gqa = TA.make_kv_cache(2, 8, 2, 16, dtype=torch.float32)
    assert not fa.v_in_k(gqa["k"], gqa["v"])


def _v_is_k_prefix(cache, where):
    for i, layer in enumerate(cache["layers"]):
        c = layer["self"]
        assert torch.equal(c["v"], c["k"][..., : c["v"].shape[-1]]), (
            where, i)


def test_mla_caches_hold_v_as_k_prefix(mla):
    """Both latent leaves are written from the same c_kv, so "v" equals
    "k"[..., :Dv] bit for bit after every write: a prefill with a
    token_mask, decodes, a commit, a seg_mask read that writes, page-pool
    growth, and in the snapshots of both pools."""
    _, tcfg, _, tp = mla
    rng = np.random.default_rng(21)
    res = SlotCacheManager(tcfg, MAX_LEN, n_slots=2, dtype=torch.float32,
                           device="cpu")
    pag = PagedSlotCacheManager(tcfg, MAX_LEN, n_slots=2,
                                dtype=torch.float32, device="cpu",
                                page_size=16, pool_pages=4)
    rids = [0, 1]
    for mgr in (res, pag):
        for r in rids:
            mgr.admit(r)
    idx = res.padded_idx(rids)

    def steps(t, real=None, **kw):
        toks = torch.tensor(t)
        for mgr, name in ((res, "resident"), (pag, "paged")):
            pv = mgr.prepare(rids, write=toks.shape[1])
            if "seg_mask" in kw:
                pos = (mgr.cache["lengths"][idx.long()][:, None]
                       + torch.arange(toks.shape[1], dtype=torch.int32))
                TM.apply(tp, tcfg, toks, pos, cache=mgr.cache, write=True,
                         slot_idx=idx, page_view=pv, **kw)
            else:
                TM.slot_extend(tp, tcfg, toks, mgr.cache, idx,
                               page_view=pv, **kw)
            for r, n in zip(rids, real or [toks.shape[1]] * 2):
                mgr.advance(r, n)
            _v_is_k_prefix(mgr.cache, name)

    tm = np.ones((2, 16), bool)
    tm[1, 11:] = False                       # a padded prefill chunk
    steps(rng.integers(0, tcfg.vocab, (2, 16)), real=[16, 11],
          token_mask=torch.tensor(tm))
    for _ in range(2):                       # decodes
        steps(rng.integers(0, tcfg.vocab, (2, 1)))
    steps(rng.integers(0, tcfg.vocab, (2, 4)))             # a commit
    G = 3
    mk = np.broadcast_to(np.array([[1, 0, 0], [1, 1, 0], [1, 0, 1]], bool),
                         (2, G, G)).copy()
    steps(rng.integers(0, tcfg.vocab, (2, G)), seg_mask=torch.tensor(mk))
    assert pag.n_page_growths >= 1           # the pool grew on the way
    snaps = {"resident": TM.gather_slots(res.cache, idx),
             "paged": TM.gather_paged_slots(tcfg, pag.cache, idx,
                                            pag.snapshot_view(rids))}
    for name, snap in snaps.items():
        _v_is_k_prefix(snap, f"{name} snapshot")
        TM.decode_step(tp, tcfg, torch.tensor(rng.integers(
            0, tcfg.vocab, (2, 1))), snap)
        _v_is_k_prefix(snap, f"{name} snapshot after a decode")


# ------------------------------------------------------- the model

def test_init_params_builds_the_reference_tree(deepseek):
    """The port's init_params gives, layer for layer, the reference's
    leaves and shapes (MLA mixers, dense and MoE FFNs, the MTP subtree);
    params_from_numpy carries the MTP subtree across bitwise."""
    cfg, tcfg, tree, tp = deepseek
    mine = TM.init_params(tcfg, 0, device="cpu")

    def shapes(t):
        if isinstance(t, dict):
            return {k: shapes(v) for k, v in t.items()}
        if isinstance(t, list):
            return [shapes(v) for v in t]
        return tuple(t.shape)

    assert shapes(mine) == shapes(tp)
    assert sorted(mine["mtp"]) == ["layer", "norm_e", "norm_h", "proj"]
    assert sorted(tp["layers"][3]["ffn"]) == sorted(tree["stages"][-1][0][
        "ffn"])
    for key in ("proj",):
        np.testing.assert_array_equal(tp["mtp"][key].numpy(),
                                      tree["mtp"][key])
    np.testing.assert_array_equal(tp["mtp"]["layer"]["mixer"]["wuk"].numpy(),
                                  tree["mtp"]["layer"]["mixer"]["wuk"])


def test_apply_matches_reference(deepseek):
    """Logits and the MoE aux loss of a DeepSeek-like model within 1e-4 of
    `repro.models.model.apply`: a self-contained forward, then prefill,
    decode, a tree verification and a commit on latent caches."""
    cfg, tcfg, tree, tp = deepseek
    jp = jax.tree.map(jnp.asarray, tree)
    B = 2
    rng = np.random.default_rng(5)
    toks = rng.integers(0, cfg.vocab, (B, 9)).astype(np.int32)
    lj, _, aj = JM.apply(jp, cfg, jnp.asarray(toks))
    lt, _, at = TM.apply(tp, tcfg, torch.tensor(toks))
    _close(lt, lj, 1e-4)
    _close(at, aj, 1e-4)
    jc = JM.init_cache(cfg, B, 40, dtype=jnp.float32)
    tc = TM.init_cache(tcfg, B, 40, dtype=torch.float32, device="cpu")
    lj, jc, _ = JM.prefill(jp, cfg, jnp.asarray(toks), jc)
    lt, tc, _ = TM.prefill(tp, tcfg, torch.tensor(toks), tc)
    _close(lt, lj, 1e-4)
    step = rng.integers(0, cfg.vocab, (B, 1)).astype(np.int32)
    lj, jc, _ = JM.decode_step(jp, cfg, jnp.asarray(step), jc)
    lt, tc, _ = TM.decode_step(tp, tcfg, torch.tensor(step), tc)
    _close(lt, lj, 1e-4)
    G = 4
    mask = np.tril(np.ones((G, G), bool))
    mask[3, 1:3] = False
    pos = np.asarray(jc["lengths"])[:, None] + np.array([0, 1, 2, 1])
    vt = rng.integers(0, cfg.vocab, (B, G)).astype(np.int32)
    mk = np.broadcast_to(mask, (B, G, G)).copy()
    lj, _, _ = JM.verify_chunk(jp, cfg, jnp.asarray(vt), jc,
                               positions=jnp.asarray(pos, jnp.int32),
                               seg_mask=jnp.asarray(mk))
    lt, _, _ = TM.verify_chunk(tp, tcfg, torch.tensor(vt), tc,
                               positions=torch.tensor(pos, dtype=torch.int32),
                               seg_mask=torch.tensor(mk))
    _close(lt, lj, 1e-4)
    ext = rng.integers(0, cfg.vocab, (B, 3)).astype(np.int32)
    lj, jc, _ = JM.extend(jp, cfg, jnp.asarray(ext), jc)
    lt, tc, _ = TM.extend(tp, tcfg, torch.tensor(ext), tc)
    _close(lt, lj, 1e-4)
    np.testing.assert_array_equal(tc["lengths"].numpy(),
                                  np.asarray(jc["lengths"]))


def test_int8_kv_refused_at_both_constructors():
    """The latent cache has no quantized layout: kv_dtype="int8" with MLA
    raises ValueError naming MLA at both cache constructors, as the
    reference's `_reject_mla_int8`."""
    cfg = _tcfg(_tiny_mla().with_overrides(kv_dtype="int8"))
    with pytest.raises(ValueError, match="mla"):
        TM.init_cache(cfg, 1, MAX_LEN, device="cpu")
    with pytest.raises(ValueError, match="mla"):
        TM.init_paged_cache(cfg, 1, page_size=16, device="cpu")


# ------------------------------------------------------- the runners

def test_padded_chunk_prefill_and_decode_match_jax_runner(mla):
    """A 13-token prompt prefilled as one padded 16-wide chunk, then
    three decodes: the port's runner within 1e-4 of the JAX runner (the
    reference's `test_padded_chunk_prefill_exotic_attention[mla]`)."""
    cfg, tcfg, tree, tp = mla
    runner = ModelRunner(tcfg, tp, max_len=MAX_LEN, device="cpu")
    jrunner = JaxRunner(cfg, jax.tree.map(jnp.asarray, tree), max_len=MAX_LEN)
    rng = np.random.default_rng(13)
    toks = rng.integers(0, cfg.vocab, 13)
    lg, _ = runner.prefill_request(0, toks)
    jlg, _ = jrunner.prefill_request(0, toks)
    _close(lg, jlg, 1e-4)
    for t in rng.integers(0, cfg.vocab, 3):
        lg, _ = runner.decode([0], np.asarray([t]))
        jlg, _ = jrunner.decode([0], np.asarray([t]))
        _close(lg, jlg, 1e-4)


@pytest.mark.parametrize("pool_pages", [0, 4])
def test_paged_runner_bitwise_resident_and_near_jax(mla, pool_pages):
    """Prefill, decode, a tree verification, ragged commits and snapshot
    drafting through slot growth and (4 pages) page-pool growth: the
    latent page pool bitwise the resident pool, both within 1e-4 of the
    JAX resident runner."""
    cfg, tcfg, tree, tp = mla
    res = ModelRunner(tcfg, tp, MAX_LEN, n_slots=2, device="cpu")
    pag = ModelRunner(tcfg, tp, MAX_LEN, n_slots=2, paged=True,
                      page_size=16, pool_pages=pool_pages, device="cpu")
    jres = JaxRunner(cfg, jax.tree.map(jnp.asarray, tree), MAX_LEN,
                     n_slots=2)
    _drive(res, pag, jres, cfg, np.random.default_rng(pool_pages))
    if pool_pages:
        assert pag.slots.n_page_growths >= 1
    for layer in pag.slots.cache["layers"]:
        c = layer["self"]
        assert c["k"].shape[2:] == (1, 40) and c["v"].shape[2:] == (1, 32)


# ------------------------------------------------------- the engine

def _greedy(cfg, params, prompt, n):
    cache = TM.init_cache(cfg, 1, MAX_LEN, dtype=torch.float32, device="cpu")
    lg, cache, _ = TM.prefill(params, cfg, torch.tensor([prompt]), cache)
    out = []
    for _ in range(n):
        out.append(int(torch.argmax(lg[0, -1, : cfg.vocab])))
        lg, cache, _ = TM.decode_step(params, cfg, torch.tensor([[out[-1]]]),
                                      cache)
    return out


def _serve(engine_cls, target, drafters, cos, prompts, **kw):
    eng = engine_cls(target, drafters, cos, strategy="cosine",
                     max_len=MAX_LEN, seed=0, **kw)
    reqs = [eng.submit(p, max_new_tokens=NEW) for p in prompts]
    stats = eng.run()
    return ([list(map(int, r.generated)) for r in reqs],
            [rec.committed for rec in stats.records], stats)


def test_engine_is_greedy_exact_and_equals_jax(deepseek):
    """A `cosine` engine serving the DeepSeek-like MLA target with a
    random tiny MLA drafter and a drafter sharing the target's weights:
    the streams equal the port's greedy decode and the JAX engine's (per
    iteration too); on the paged pool they equal the resident streams;
    on the wall-clock backend they are greedy-exact too."""
    cfg, tcfg, tree, tp = deepseek
    dcfg, tdcfg, dtree, tdp = _models(
        _tiny_mla().with_overrides(name="tiny-mla-draft", n_layers=1,
                                   vocab=cfg.vocab, tie_embeddings=True),
        seed=1)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, cfg.vocab, n).tolist() for n in (8, 19)]
    drafters = [(tdcfg, tdp, "d0"), (tcfg, tp, "d1")]
    streams = {}
    for mode in ("resident", "paged", "async"):
        cos = CoSineConfig(n_drafters=2, draft_len=4, drafters_per_request=2,
                           tree_width=2, paged_pool=mode == "paged",
                           page_size=16, pool_pages=4)
        streams[mode], iters, stats = _serve(
            SpeculativeEngine, (tcfg, tp), drafters, _tcfg(cos), prompts,
            device="cpu", backend="async" if mode == "async" else None)
        assert stats.mean_acceptance > 1.0
        if mode == "resident":
            res_iters = iters
    greedy = [_greedy(tcfg, tp, p, NEW) for p in prompts]
    assert streams["resident"] == streams["paged"] == streams["async"] \
        == greedy
    cos = CoSineConfig(n_drafters=2, draft_len=4, drafters_per_request=2,
                       tree_width=2)
    j_streams, j_iters, _ = _serve(
        JaxEngine, (cfg, tree), [(dcfg, dtree, "d0"), (cfg, tree, "d1")],
        cos, prompts)
    assert streams["resident"] == j_streams
    assert res_iters == j_iters
