"""The remaining architectures of the PyTorch port against `repro`:
h2o-danube3-4b (head width 120, SWA), cross-attention (the VLM layout of
llama-3.2-vision-11b) and the Whisper encoder-decoder (whisper-small), at
reduced widths and f32, on the same numpy weights (norm scales and biases
perturbed so that they count), within 1e-4.

* (a) The reduced h2o-danube3-4b at head width 120: `apply` against
  `repro.models.model.apply`, and the slot steps (prefill, extends and
  decodes past its 64-key window) against the reference's slot steps.
* (b) The reference's tiny cross config (`tests/test_runner_slots.py`):
  `slot_extend(frontend=...)` writes the projected cross rows in place
  and the decodes read them; logits and the written cross rows against
  the reference's slot steps.
* (c) The reduced whisper-small: `apply(frontend=...)` against the
  reference, prefill then decode against the port's full forward, and
  the encoder subtree carried across by `params_from_numpy`.
* (d) A paged cache holds the cross leaves slot-indexed: the paged slot
  steps are bitwise the resident ones with a frontend written; slot
  growth keeps the cross rows, re-admission empties them; the runners'
  paged pool is bitwise the resident one and near the JAX runner.
* (e) A `cosine` engine on the tiny cross and the tiny encoder-decoder
  targets commits the port's own greedy streams (serving passes no
  frontend, as in the reference, so no JAX engine parity is owed).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _jax_fast_compile import fast_compile
from repro.config import ModelConfig
from repro.configs import ARCHS
from repro.models import model as JM
from repro.serving.runner import ModelRunner as JaxRunner
from repro_torch import config as tconfig
from repro_torch.config import CoSineConfig
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


TOL = 1e-4
MAX_LEN = 96
NEW = 8
# leaves the random init leaves at 1 or 0 (norms, biases): perturbed
PERTURBED = ("scale", "bias", "bi", "bo", "bq", "bk", "bv")


def _tiny_cross():
    """The reference's tiny cross config (tests/test_runner_slots.py)."""
    return ModelConfig(name="tiny-cross", family="dense", n_layers=2,
                       d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
                       d_ff=128, vocab=50, tie_embeddings=True,
                       dtype="float32", cross_attn_period=2,
                       n_frontend_tokens=4)


def _danube():
    return ARCHS["h2o-danube3-4b"].reduced().with_overrides(
        head_dim=120, dtype="float32")


def _whisper():
    return ARCHS["whisper-small"].reduced().with_overrides(dtype="float32")


def _tiny_whisper():
    """whisper-small's layout at the narrowest widths (engine runs)."""
    return _whisper().with_overrides(d_model=64, n_heads=4, n_kv_heads=4,
                                     head_dim=16, d_ff=128, vocab=60,
                                     max_position=128, encoder_seq=6,
                                     n_frontend_tokens=6)


def _perturb(tree, rng):
    if isinstance(tree, dict):
        return {k: (v + rng.normal(0, 0.1, v.shape).astype(v.dtype)
                    if k in PERTURBED and not isinstance(v, dict)
                    else _perturb(v, rng)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_perturb(v, rng) for v in tree)
    return tree


def _models(cfg, seed=0):
    tree = jax.tree.map(np.asarray,
                        JM.init_params(jax.random.PRNGKey(seed), cfg))
    tree = _perturb(tree, np.random.default_rng(seed + 100))
    tcfg = tconfig.ModelConfig(**{f.name: getattr(cfg, f.name)
                                  for f in dataclasses.fields(cfg)})
    return cfg, tcfg, tree, params_from_numpy(tree, tcfg, "cpu")


def _close(t, j, tol=TOL):
    np.testing.assert_allclose(
        t.detach().numpy() if torch.is_tensor(t) else np.asarray(t),
        np.asarray(j), rtol=tol, atol=tol)


def _frontend(cfg, batch, seed):
    return (np.random.default_rng(seed).standard_normal(
        (batch, cfg.n_frontend_tokens, cfg.d_model)) * 0.1).astype(np.float32)


@pytest.fixture(scope="module")
def danube():
    return _models(_danube())


@pytest.fixture(scope="module")
def cross():
    return _models(_tiny_cross())


@pytest.fixture(scope="module")
def whisper():
    return _models(_whisper())


# ------------------------------------------------ (a) h2o-danube3-4b

def test_danube_head_120_matches_reference(danube):
    """`apply`, then prefill / extends / decodes into a slot pool past the
    64-key window: logits within 1e-4 of the reference's, lengths and K/V
    rows equal."""
    cfg, tcfg, tree, tp = danube
    assert tcfg.resolved_head_dim == 120 and tcfg.sliding_window == 64
    jp = jax.tree.map(jnp.asarray, tree)
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab, (2, 12)).astype(np.int32)
    lj, _, _ = JM.apply(jp, cfg, jnp.asarray(toks))
    lt, _, _ = TM.apply(tp, tcfg, torch.tensor(toks))
    _close(lt, lj)

    jc = JM.init_cache(cfg, 4, MAX_LEN, dtype=jnp.float32)
    tc = TM.init_cache(tcfg, 4, MAX_LEN, dtype=torch.float32, device="cpu")
    idx = np.array([3, 1], np.int32)
    for width in (40, 30, 1, 1, 1):      # positions 0..72: past the window
        t = rng.integers(0, cfg.vocab, (2, width)).astype(np.int32)
        step_j = JM.slot_decode_step if width == 1 else JM.slot_extend
        step_t = TM.slot_decode_step if width == 1 else TM.slot_extend
        lj, jc, _ = step_j(jp, cfg, jnp.asarray(t), jc, jnp.asarray(idx))
        lt, tc, _ = step_t(tp, tcfg, torch.tensor(t), tc, torch.tensor(idx))
        _close(lt, lj)
    np.testing.assert_array_equal(tc["lengths"].numpy(),
                                  np.asarray(jc["lengths"]))
    assert int(tc["lengths"][3]) == 73
    _close(tc["layers"][1]["self"]["k"], jc["stages"][0][0]["self"]["k"][1])


# ------------------------------------------------ (b) cross-attention

def test_cross_slot_steps_match_reference(cross):
    """Prefill with a frontend writes each cross layer's rows (columns
    0..S-1, slot_pos arange(S)) into the active slots in place; decodes
    without it read them through slot_idx: logits within 1e-4 of the
    reference's slot steps, cross rows equal to the reference's."""
    cfg, tcfg, tree, tp = cross
    jp = jax.tree.map(jnp.asarray, tree)
    rng = np.random.default_rng(13)
    idx = np.array([1, 3], np.int32)
    toks = rng.integers(0, cfg.vocab, (2, 6)).astype(np.int32)
    fe = _frontend(cfg, 2, 14)
    jc = JM.init_cache(cfg, 4, MAX_LEN, dtype=jnp.float32)
    tc = TM.init_cache(tcfg, 4, MAX_LEN, dtype=torch.float32, device="cpu")
    cross_layers = [i for i, lay in enumerate(tc["layers"]) if "cross" in lay]
    assert cross_layers == [0] and tc["layers"][0]["cross"]["k"].shape == (
        4, 4, 2, 16)
    lj, jc, _ = JM.slot_extend(jp, cfg, jnp.asarray(toks), jc,
                               jnp.asarray(idx), frontend=jnp.asarray(fe))
    lt, tc, _ = TM.slot_extend(tp, tcfg, torch.tensor(toks), tc,
                               torch.tensor(idx), frontend=torch.tensor(fe))
    _close(lt, lj)
    jcross = jc["stages"][0][0]["cross"]
    for f in ("k", "v", "slot_pos"):
        _close(tc["layers"][0]["cross"][f], jcross[f][0])
    np.testing.assert_array_equal(tc["layers"][0]["cross"]["slot_pos"][1],
                                  np.arange(4))
    assert bool((tc["layers"][0]["cross"]["slot_pos"][[0, 2]] == -1).all())
    for _ in range(3):
        t = rng.integers(0, cfg.vocab, (2, 1)).astype(np.int32)
        lj, jc, _ = JM.slot_decode_step(jp, cfg, jnp.asarray(t), jc,
                                        jnp.asarray(idx))
        lt, tc, _ = TM.slot_decode_step(tp, tcfg, torch.tensor(t), tc,
                                        torch.tensor(idx))
        _close(lt, lj)
    # a tree verification reads the cross rows too, and writes nothing
    before = {f: t.clone() for f, t in tc["layers"][0]["cross"].items()}
    vt = rng.integers(0, cfg.vocab, (2, 3)).astype(np.int32)
    rel = np.broadcast_to(np.array([0, 1, 1], np.int32), (2, 3))
    mk = np.broadcast_to(np.array([[1, 0, 0], [1, 1, 0], [1, 0, 1]], bool),
                         (2, 3, 3))
    lj = JM.slot_verify_chunk(jp, cfg, jnp.asarray(vt), jc, jnp.asarray(idx),
                              jnp.asarray(rel), jnp.asarray(mk))
    lt = TM.slot_verify_chunk(tp, tcfg, torch.tensor(vt), tc,
                              torch.tensor(idx), torch.tensor(rel.copy()),
                              torch.tensor(mk.copy()))
    _close(lt, lj)
    assert all(torch.equal(before[f], t)
               for f, t in tc["layers"][0]["cross"].items())


def test_cross_reads_of_empty_rows_are_zero(cross):
    """Without a frontend (as serving runs) every cross key is masked:
    l = 0 and the block adds exactly 0, as the reference's
    where(l == 0, 1, l)."""
    cfg, tcfg, tree, tp = cross
    from repro_torch.models import attention as TA
    tc = TM.init_cache(tcfg, 3, MAX_LEN, dtype=torch.float32, device="cpu")
    x = torch.randn(2, 5, tcfg.d_model)
    out, written = TA.cross_attention(tp["layers"][0]["cross"], tcfg, x,
                                      cache=tc["layers"][0]["cross"],
                                      slot_idx=torch.tensor([2, 1]))
    assert written is None and bool((out == 0).all())


# ------------------------------------------------ (c) whisper

def test_whisper_apply_and_cached_decode(whisper):
    """The encoder-decoder's full forward against the reference's within
    1e-4; prefill with the frames, then decodes reading the encoder's
    cross rows, against the port's own full forward (the reference's
    `test_decode_with_cache_matches_full`); the encoder subtree carried
    across leaf for leaf."""
    cfg, tcfg, tree, tp = whisper
    enc = tp["encoder"]
    assert len(enc["layers"]) == cfg.encoder_layers == 2
    assert enc["pos"].shape == (cfg.encoder_seq, cfg.d_model)
    for i, lay in enumerate(enc["layers"]):
        assert sorted(lay) == ["ffn", "ln1", "ln2", "mixer"]
        np.testing.assert_array_equal(
            lay["mixer"]["wq"].numpy(),
            tree["encoder"]["stage"][0]["mixer"]["wq"][i])
        np.testing.assert_array_equal(
            lay["ln1"]["bias"].numpy(),
            tree["encoder"]["stage"][0]["ln1"]["bias"][i])
    np.testing.assert_array_equal(enc["final_norm"]["scale"].numpy(),
                                  tree["encoder"]["final_norm"]["scale"])
    assert sorted(tp["layers"][0]) == ["cross", "ffn", "ln1", "ln2",
                                       "ln_cross", "mixer"]
    jp = jax.tree.map(jnp.asarray, tree)
    rng = np.random.default_rng(2)
    toks = rng.integers(0, cfg.vocab, (2, 12)).astype(np.int32)
    fe = _frontend(cfg, 2, 3)
    lj, _, _ = JM.apply(jp, cfg, jnp.asarray(toks), frontend=jnp.asarray(fe))
    full, _, _ = TM.apply(tp, tcfg, torch.tensor(toks),
                          frontend=torch.tensor(fe))
    _close(full, lj)
    cache = TM.init_cache(tcfg, 2, 32, dtype=torch.float32, device="cpu")
    assert cache["layers"][1]["cross"]["k"].shape == (2, cfg.encoder_seq,
                                                      4, 64)
    lp, cache, _ = TM.prefill(tp, tcfg, torch.tensor(toks[:, :8]), cache,
                              frontend=torch.tensor(fe))
    _close(lp, full[:, :8])
    for t in range(8, 12):
        ls, cache, _ = TM.decode_step(tp, tcfg, torch.tensor(toks[:, t:t + 1]),
                                      cache)
        _close(ls[:, 0], full[:, t])


# ------------------------------------------------ (d) the paged pool

def test_paged_cross_leaves(cross):
    """Cross leaves stay slot-indexed beside the page pools: prefill with
    a frontend and decodes on the paged cache bitwise the resident
    cache's; slot growth keeps the written cross rows, re-admission of a
    slot empties them (slot_pos -1); a snapshot copies them."""
    _, tcfg, _, tp = cross
    res = SlotCacheManager(tcfg, MAX_LEN, n_slots=2, dtype=torch.float32,
                           device="cpu")
    pag = PagedSlotCacheManager(tcfg, MAX_LEN, n_slots=2, dtype=torch.float32,
                                device="cpu", page_size=16, pool_pages=4)
    assert set(pag.cache["layers"][0]) == {"self", "cross"}
    assert pag.cache["layers"][0]["cross"]["k"].shape[0] == 3
    rng = np.random.default_rng(5)
    fe = torch.tensor(_frontend(tcfg, 2, 6))
    rids = [0, 1]
    outs = {}
    for mgr in (res, pag):
        for r in rids:
            mgr.admit(r)
        idx = mgr.padded_idx(rids)
        g = np.random.default_rng(7)
        toks = torch.tensor(g.integers(0, tcfg.vocab, (2, 20)))
        pv = mgr.prepare(rids, write=20)
        lg, _, _ = TM.slot_extend(tp, tcfg, toks, mgr.cache, idx,
                                  frontend=fe, page_view=pv)
        for r in rids:
            mgr.advance(r, 20)
        steps = [lg]
        for _ in range(2):
            pv = mgr.prepare(rids, write=1)
            lg, _, _ = TM.slot_decode_step(
                tp, tcfg, torch.tensor(g.integers(0, tcfg.vocab, (2, 1))),
                mgr.cache, idx, page_view=pv)
            for r in rids:
                mgr.advance(r, 1)
            steps.append(lg)
        outs[mgr is pag] = steps
    for a, b in zip(outs[False], outs[True]):
        assert torch.equal(a, b)
    cr = pag.cache["layers"][0]["cross"]
    written = {f: t[1:3].clone() for f, t in cr.items()}
    assert bool((written["slot_pos"] == torch.arange(4)).all())
    # a snapshot copies the cross rows of its slots
    snap = TM.gather_paged_slots(tcfg, pag.cache, pag.padded_idx(rids),
                                 pag.snapshot_view(rids))
    for f in written:
        assert torch.equal(snap["layers"][0]["cross"][f][:2], written[f])
    # slot growth (a third request) and pool growth keep them
    for r in (2, 3):
        pag.admit(r)
        pag.ensure(r, 40)
    assert pag.n_slots == 4 and pag.n_page_growths >= 1
    cr = pag.cache["layers"][0]["cross"]
    assert cr["k"].shape[0] == 5
    for f in written:
        assert torch.equal(cr[f][1:3], written[f])
    # re-admission empties a recycled slot's cross rows
    pag.release(0)
    pag.admit(9)
    slot = pag.slot_of[9]
    assert slot == 1 and bool((cr["slot_pos"][slot] == -1).all())
    assert torch.equal(cr["slot_pos"][2], written["slot_pos"][1])
    # the resident manager alike: growth keeps, re-admission empties
    for r in (2, 3):
        res.admit(r)
    rcr = res.cache["layers"][0]["cross"]
    assert res.n_slots == 4 and rcr["k"].shape[0] == 5
    for f in written:
        assert torch.equal(rcr[f][1:3], written[f])
    res.release(0)
    res.admit(9)
    assert res.slot_of[9] == 1 and bool((rcr["slot_pos"][1] == -1).all())
    assert bool((rcr["k"][1] == 0).all())


def test_paged_runner_with_cross_layers_bitwise_resident(cross):
    """The runners' paged pool bitwise the resident pool and both within
    1e-4 of the JAX resident runner on a cross-attention target (empty
    cross rows, as serving holds them), through slot and pool growth."""
    cfg, tcfg, tree, tp = cross
    res = ModelRunner(tcfg, tp, MAX_LEN, n_slots=2, device="cpu")
    pag = ModelRunner(tcfg, tp, MAX_LEN, n_slots=2, paged=True,
                      page_size=16, pool_pages=4, device="cpu")
    jres = JaxRunner(cfg, jax.tree.map(jnp.asarray, tree), MAX_LEN,
                     n_slots=2)
    _drive(res, pag, jres, cfg, np.random.default_rng(4))
    assert pag.slots.n_page_growths >= 1
    for layer in pag.slots.cache["layers"]:
        if "cross" in layer:
            assert layer["cross"]["k"].shape[0] == pag.slots.n_slots + 1


# ------------------------------------------------ (e) the engine

def _greedy(cfg, params, prompt, n):
    cache = TM.init_cache(cfg, 1, MAX_LEN, dtype=torch.float32, device="cpu")
    lg, cache, _ = TM.prefill(params, cfg, torch.tensor([prompt]), cache)
    out = []
    for _ in range(n):
        out.append(int(torch.argmax(lg[0, -1, : cfg.vocab])))
        lg, cache, _ = TM.decode_step(params, cfg, torch.tensor([[out[-1]]]),
                                      cache)
    return out


@pytest.mark.parametrize("arch,paged", [("cross", True), ("encdec", False)])
def test_engine_is_greedy_exact(arch, paged):
    """`cosine` with a random drafter and one sharing the target's
    weights (the cross target on a paged pool that must grow, the
    encoder-decoder on the resident pool): every stream equals the port's
    greedy decode."""
    make = _tiny_cross if arch == "cross" else _tiny_whisper
    cfg = make()
    tcfg = tconfig.ModelConfig(**{f.name: getattr(cfg, f.name)
                                  for f in dataclasses.fields(cfg)})
    tp = TM.init_params(tcfg, 0, device="cpu")
    dp = TM.init_params(tcfg, 1, device="cpu")
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, tcfg.vocab, n).tolist() for n in (5, 17)]
    cos = CoSineConfig(n_drafters=2, draft_len=4, drafters_per_request=2,
                       tree_width=2, paged_pool=paged, page_size=16,
                       pool_pages=4)
    eng = SpeculativeEngine((tcfg, tp), [(tcfg, dp, "d0"), (tcfg, tp, "d1")],
                            cos, strategy="cosine", max_len=MAX_LEN, seed=0,
                            device="cpu")
    reqs = [eng.submit(p, max_new_tokens=NEW) for p in prompts]
    stats = eng.run()
    assert [list(map(int, r.generated)) for r in reqs] == [
        _greedy(tcfg, tp, p, NEW) for p in prompts]
    assert stats.mean_acceptance > 1.0
    if paged:
        assert eng.target.slots.n_page_growths > 0
