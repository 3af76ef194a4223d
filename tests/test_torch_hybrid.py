"""The port's SSM and hybrid caches, paged pool and engine against `repro`
and against the port's own resident path, on the CPU.

* Slot-cache helpers (gather, scatter, reset, concat) carry the SSM
  leaves as the reference's do; SSM state stays float32 under a bf16
  cache, resident and paged.
* The paged helpers (init, gather, page reset, slot reset, slot and page
  growth) mirror the reference's on SSM and hybrid plans; a model without
  attention has no pools.
* Paged runner steps (prefill, decode, chain verification, commit,
  snapshot drafting, slot growth) are bitwise the port's resident steps,
  and within 1e-4 of the JAX resident runner (not the JAX paged runner:
  its own bitwise hybrid test fails in `test_paged_pool.py` here).
* The paged manager of a model without attention keeps the reference
  manager's block tables and free lists.

The engine on these targets is `tests/test_torch_ssm_engine.py`.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _jax_fast_compile import fast_compile
from conftest import tiny_model_cfg
from repro.config import CoSineConfig
from repro.models import model as JM
from repro.serving.runner import ModelRunner as JaxRunner
from repro.serving.runner import PagedSlotCacheManager as JaxManager
from repro_torch import config as tconfig
from repro_torch.models import model as TM
from repro_torch.models.convert import params_from_numpy
from repro_torch.serving.runner import ModelRunner, PagedSlotCacheManager
from test_torch_ssm import caches_close


@pytest.fixture(scope="module", autouse=True)
def _fast_reference_compile():
    """The JAX package's programs compiled cheaply (`_jax_fast_compile`)."""
    with fast_compile():
        yield


MAX_LEN = 96
TOL = 1e-4


def _tcfg(cfg):
    cls = (tconfig.CoSineConfig if isinstance(cfg, CoSineConfig)
           else tconfig.ModelConfig)
    return cls(**{f.name: getattr(cfg, f.name)
                  for f in dataclasses.fields(cfg)})


def _eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.fixture(scope="module", params=["ssm", "hybrid"])
def models(request):
    cfg = tiny_model_cfg(request.param)
    tree = jax.tree.map(np.asarray, JM.init_params(jax.random.PRNGKey(0),
                                                   cfg))
    return cfg, _tcfg(cfg), tree, params_from_numpy(tree, _tcfg(cfg), "cpu")


def _tokens(seed, shape, vocab):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


# ------------------------------------------------------------- slot caches

def test_slot_cache_helpers_with_ssm_leaves(models):
    """gather_slots, scatter_slots, reset_slots and concat_slots on a pool
    holding SSM state mirror the reference's."""
    cfg, tcfg, tree, tp = models
    jp = jax.tree.map(jnp.asarray, tree)
    jc = JM.init_cache(cfg, 4, MAX_LEN, dtype=jnp.float32)
    tc = TM.init_cache(tcfg, 4, MAX_LEN, dtype=torch.float32, device="cpu")
    sidx = np.array([2, 1], np.int32)
    toks = _tokens(10, (2, 6), cfg.vocab)
    _, jc, _ = JM.slot_extend(jp, cfg, jnp.asarray(toks), jc,
                              jnp.asarray(sidx))
    TM.slot_extend(tp, tcfg, torch.tensor(toks), tc, torch.tensor(sidx))
    caches_close(tc, jc, tcfg)
    jsub = JM.gather_slots(jc, jnp.asarray(sidx))
    tsub = TM.gather_slots(tc, torch.tensor(sidx))
    caches_close(tsub, jsub, tcfg)
    # decoding on the snapshot never touches the pool
    before = [{f: t.clone() for f, t in layer["self"].items()}
              for layer in tc["layers"]]
    TM.decode_step(tp, tcfg, torch.tensor(_tokens(11, (2, 1), cfg.vocab)),
                   tsub)
    for b, layer in zip(before, tc["layers"]):
        for f, t in layer["self"].items():
            assert torch.equal(b[f], t)
    dst = np.array([3, 0], np.int32)
    jc2 = JM.scatter_slots(jc, jsub, jnp.asarray(dst))
    TM.scatter_slots(tc, TM.gather_slots(tc, torch.tensor(sidx)),
                     torch.tensor(dst))
    caches_close(tc, jc2, tcfg)
    # reset: what scattering a pristine cache into the slots does
    jc3 = JM.scatter_slots(jc2, JM.init_cache(cfg, 1, MAX_LEN,
                                              dtype=jnp.float32),
                           jnp.asarray([2], jnp.int32))
    TM.reset_slots(tc, torch.tensor([2]))
    caches_close(tc, jc3, tcfg)
    jbig = JM.concat_slots(jc3, JM.init_cache(cfg, 2, MAX_LEN,
                                              dtype=jnp.float32))
    tbig = TM.concat_slots(tc, TM.init_cache(tcfg, 2, MAX_LEN,
                                             dtype=torch.float32,
                                             device="cpu"))
    caches_close(tbig, jbig, tcfg)


@pytest.mark.parametrize("paged", [False, True])
def test_ssm_state_stays_f32_under_bf16_cache(paged):
    """A bf16 cache holds bf16 K/V and float32 SSM state, as the
    reference's; a slot step keeps it so."""
    cfg = tiny_model_cfg("hybrid").with_overrides(dtype="bfloat16")
    tcfg = _tcfg(cfg)
    if paged:
        jc = JM.init_paged_cache(cfg, 3, jnp.bfloat16, page_size=8,
                                 n_pages=6)
        tc = TM.init_paged_cache(tcfg, 3, torch.bfloat16, page_size=8,
                                 n_pages=6, device="cpu")
    else:
        jc = JM.init_cache(cfg, 3, 16, dtype=jnp.bfloat16)
        tc = TM.init_cache(tcfg, 3, 16, dtype=torch.bfloat16, device="cpu")
    want = [stage[j]["self"] for (pattern, reps), stage
            in zip(TM.layer_plan(tcfg), jc["stages"])
            for _ in range(reps) for j in range(len(pattern))]
    for tl, jl in zip(tc["layers"], want):
        for f, t in tl["self"].items():
            assert str(t.dtype).split(".")[-1] == str(jl[f].dtype), f
            assert tuple(t.shape) == tuple(jl[f].shape[1:]), f
    kinds = {f: t.dtype for layer in tc["layers"]
             for f, t in layer["self"].items()}
    assert kinds == {"ssm": torch.float32, "conv": torch.float32,
                     "pos": torch.int32, "k": torch.bfloat16,
                     "v": torch.bfloat16, "slot_pos": torch.int32}
    tp = TM.init_params(tcfg, 0, device="cpu")
    sidx = torch.tensor([1, 2], dtype=torch.int32)
    pv = torch.tensor([[2, 1], [3, 1]], dtype=torch.int32) if paged else None
    TM.slot_extend(tp, tcfg, torch.tensor(_tokens(1, (2, 5), cfg.vocab)),
                   tc, sidx, page_view=pv)
    ssm = tc["layers"][0]["self"]["ssm"]
    assert ssm.dtype == torch.float32 and bool(ssm[1:].abs().sum() > 0)


# ------------------------------------------------------------- paged helpers

def _paged_pair(cfg, tcfg, batch=3, n_pages=6, ps=8):
    jc = JM.init_paged_cache(cfg, batch, jnp.float32, page_size=ps,
                             n_pages=n_pages)
    tc = TM.init_paged_cache(tcfg, batch, torch.float32, page_size=ps,
                             n_pages=n_pages, device="cpu")
    return jc, tc


def test_paged_helpers_mirror_reference(models):
    """init_paged_cache, paged_pool_shape, gather_paged_slots,
    reset_pages, reset_slot_state, concat_slots_paged and grow_pages on an
    SSM or hybrid plan, leaf for leaf against the reference's."""
    cfg, tcfg, tree, tp = models
    jp = jax.tree.map(jnp.asarray, tree)
    jc, tc = _paged_pair(cfg, tcfg)
    caches_close(tc, jc, tcfg)
    shape = TM.paged_pool_shape(tcfg, tc)
    assert shape == JM.paged_pool_shape(cfg, jc)
    assert shape == (None if cfg.family == "ssm" else (6, 8))
    # write two requests through the block table, then snapshot them
    sidx = np.array([1, 2], np.int32)
    pv = np.array([[2, 3], [4, 5]], np.int32)
    toks = _tokens(3, (2, 12), cfg.vocab)
    _, jc, _ = JM.slot_extend(jp, cfg, jnp.asarray(toks), jc,
                              jnp.asarray(sidx), page_view=jnp.asarray(pv))
    TM.slot_extend(tp, tcfg, torch.tensor(toks), tc, torch.tensor(sidx),
                   page_view=torch.tensor(pv))
    caches_close(tc, jc, tcfg)
    view = np.array([[2, 3, 1, 1], [4, 5, 1, 1]], np.int32)
    jsnap = JM.gather_paged_slots(cfg, jc, jnp.asarray(sidx),
                                  jnp.asarray(view))
    tsnap = TM.gather_paged_slots(tcfg, tc, torch.tensor(sidx),
                                  torch.tensor(view))
    caches_close(tsnap, jsnap, tcfg)
    jc = JM.reset_pages(cfg, jc, jnp.asarray([3], jnp.int32))
    TM.reset_pages(tcfg, tc, torch.tensor([3]))
    caches_close(tc, jc, tcfg)
    jc = JM.reset_slot_state(cfg, jc, jnp.asarray([2], jnp.int32))
    TM.reset_slot_state(tcfg, tc, torch.tensor([2]))
    caches_close(tc, jc, tcfg)
    jx, tx = _paged_pair(cfg, tcfg, batch=2, n_pages=2)
    jc = JM.concat_slots_paged(cfg, jc, jx)
    tc = TM.concat_slots_paged(tcfg, tc, tx)
    caches_close(tc, jc, tcfg)
    jc = JM.grow_pages(cfg, jc, 4)
    TM.grow_pages(tcfg, tc, 4)
    caches_close(tc, jc, tcfg)
    assert TM.paged_pool_shape(tcfg, tc) == (None if cfg.family == "ssm"
                                             else (10, 8))
    assert int(tc["lengths"].shape[0]) == 5


def test_slot_leaves_grow_slots_as_a_paged_cache_does(models):
    """init_slot_leaves holds a paged cache's slot-indexed leaves and no
    pool; concat_slots_paged appends them exactly as it appends a whole
    paged cache's."""
    cfg, tcfg, tree, tp = models
    leaves = TM.init_slot_leaves(tcfg, 2, device="cpu")
    _, full = _paged_pair(cfg, tcfg, batch=2, n_pages=2)
    for spec, a, b in zip(TM.layer_specs(tcfg), leaves["layers"],
                          full["layers"]):
        if spec.mixer != "ssm":
            assert a == {}
            continue
        assert a["self"].keys() == b["self"].keys()
        for f, t in b["self"].items():
            assert a["self"][f].dtype == t.dtype and torch.equal(
                a["self"][f], t)
    assert torch.equal(leaves["lengths"], full["lengths"])
    grown = []
    for extra in (leaves, full):
        _, tc = _paged_pair(cfg, tcfg)
        sidx = torch.tensor([1, 2])
        TM.slot_extend(tp, tcfg, torch.tensor(_tokens(4, (2, 5), cfg.vocab)),
                       tc, sidx, page_view=torch.tensor([[2, 3], [4, 5]]))
        grown.append(TM.concat_slots_paged(tcfg, tc, extra))
    a, b = grown
    assert torch.equal(a["lengths"], b["lengths"])
    for la, lb in zip(a["layers"], b["layers"]):
        for f, t in lb["self"].items():
            assert torch.equal(la["self"][f], t)


# ------------------------------------------------------------- the runners

def _runners(models, **paged_kw):
    cfg, tcfg, tree, tp = models
    res = ModelRunner(tcfg, tp, MAX_LEN, n_slots=2, device="cpu")
    pag = ModelRunner(tcfg, tp, MAX_LEN, n_slots=2, paged=True,
                      device="cpu", page_size=16, **paged_kw)
    jres = JaxRunner(cfg, jax.tree.map(jnp.asarray, tree), MAX_LEN,
                     n_slots=2)
    return res, pag, jres, cfg


def _same(res_out, pag_out, jax_out):
    _eq(res_out, pag_out)
    np.testing.assert_allclose(pag_out, jax_out, rtol=TOL, atol=TOL)


def _drive(res, pag, jres, cfg, rng):
    """Prefill three requests (the third grows the slots), decode, verify
    a chain, commit ragged chains and draft on snapshots, comparing every
    result."""
    rids = [0, 1, 2]
    for rid in rids:
        toks = rng.integers(0, cfg.vocab, 7 + 9 * rid)
        _same(*(r.prefill_request(rid, toks)[0] for r in (res, pag, jres)))
    for _ in range(2):
        step = rng.integers(0, cfg.vocab, 3)
        _same(*(r.decode(rids, step)[0] for r in (res, pag, jres)))
    G = 5
    vt = rng.integers(0, cfg.vocab, (3, G))
    rel = np.broadcast_to(np.arange(G, dtype=np.int32), (3, G))
    mk = np.broadcast_to(np.tril(np.ones((G, G), bool)), (3, G, G))
    _same(*(r.verify(rids, vt, rel, mk) for r in (res, pag, jres)))
    commits = {0: [1, 2], 1: [3], 2: [4, 5, 6]}
    outs = [r.extend_committed(commits) for r in (res, pag, jres)]
    for rid in commits:
        _same(*(o[rid] for o in outs))
        assert res.length(rid) == pag.length(rid) == jres.length(rid)
    snaps = [r.speculative_caches(rids) for r in (res, pag, jres)]
    held = pag.slots.pages_held()
    for _ in range(3):
        t = rng.integers(0, cfg.vocab, 3)
        outs = [r.decode(rids, t, caches=s)
                for r, s in zip((res, pag, jres), snaps)]
        snaps = [o[1] for o in outs]
        _same(*(o[0] for o in outs))
    ext = rng.integers(0, cfg.vocab, (3, 2))
    _same(*(r.extend_snapshot(s, ext)[0]
            for r, s in zip((res, pag, jres), snaps)))
    # the snapshot was a copy: the pool neither grew nor advanced
    assert pag.slots.pages_held() == held
    assert [pag.length(r) for r in rids] == [res.length(r) for r in rids]
    step = rng.integers(0, cfg.vocab, 3)
    _same(*(r.decode(rids, step)[0] for r in (res, pag, jres)))
    return rids


@pytest.mark.parametrize("pool_pages", [0, 4])
def test_paged_steps_match_resident_and_jax(models, pool_pages):
    """Bitwise the port's resident runner, within 1e-4 of the JAX one;
    with pool_pages=4 the page pools must grow, and evicting a request
    and admitting another reuses its slot with fresh SSM state."""
    res, pag, jres, cfg = _runners(models, pool_pages=pool_pages)
    rng = np.random.default_rng(pool_pages)
    rids = _drive(res, pag, jres, cfg, rng)
    assert pag.slots.n_slots == 4                 # the slots grew once
    if pool_pages and cfg.family == "hybrid":
        assert pag.slots.n_page_growths >= 1
    for r in (res, pag, jres):
        r.drop(1)
    toks = rng.integers(0, cfg.vocab, 30)
    _same(*(r.prefill_request(9, toks)[0] for r in (res, pag, jres)))
    live = [rids[0], rids[2], 9]
    step = rng.integers(0, cfg.vocab, 3)
    _same(*(r.decode(live, step)[0] for r in (res, pag, jres)))


@pytest.mark.parametrize("seed", range(3))
def test_manager_without_attention_matches_reference(seed):
    """An SSM model has no page pools, yet the paged manager keeps block
    tables as the reference's does: same tables, free lists and pool size
    on the same admit/prepare/advance/release stream."""
    cfg = tiny_model_cfg("ssm")
    ref = JaxManager(cfg, MAX_LEN, n_slots=2, page_size=16, pool_pages=6)
    mgr = PagedSlotCacheManager(_tcfg(cfg), MAX_LEN, n_slots=2,
                                device="cpu", page_size=16, pool_pages=6)
    assert TM.paged_pool_shape(mgr.cfg, mgr.cache) is None
    rng = np.random.default_rng(seed)
    live = set()
    for _ in range(40):
        r = int(rng.integers(0, 6))
        kind = rng.choice(["admit", "write", "release"])
        if kind == "admit" and r not in live:
            for m in (ref, mgr):
                m.admit(r)
            live.add(r)
        elif kind == "write" and r in live:
            n = int(rng.integers(1, 40))
            for m in (ref, mgr):
                m.prepare([r], write=n)
                m.advance(r, n)
        elif kind == "release" and r in live:
            for m in (ref, mgr):
                m.release(r)
            live.discard(r)
        assert mgr.tables == ref.tables
        assert mgr._free_pages == ref._free_pages
        assert mgr.n_pages == ref.n_pages
        assert mgr.n_slots == ref.n_slots
        assert int(mgr.cache["lengths"].shape[0]) == mgr.n_slots + 1
        assert int(mgr.cache["layers"][0]["self"]["ssm"].shape[0]) \
            == mgr.n_slots + 1
