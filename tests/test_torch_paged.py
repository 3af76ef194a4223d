"""The paged KV pool of the PyTorch port against `repro` and against the
port's own resident slot cache.

* The paged kernel's plain version (what its wrapper runs on CPU
  tensors) matches the reference oracle `decode_attention_paged_ref` and
  the Pallas `decode_attention_paged` in interpret mode (1e-5), with and
  without a window; NULL view entries are exact no-ops; the multi-row
  form is bitwise the resident plain version on the gathered view.
* Paged slot steps (prefill, batched decode, tree verification, commit,
  snapshot drafting) are bitwise the port's resident steps on the CPU —
  through slot growth, pool growth, eviction and reuse — and within 1e-4
  of the JAX resident runner. (Not the JAX paged runner: its own bitwise
  tests fail in `test_paged_pool.py` on this stack.)
* `PagedSlotCacheManager` holds the reference manager's block tables,
  views and free lists on the same admit/prepare/advance/release stream;
  no page leaks or aliasing, windowed tables are fixed rings.
* The engine with `paged_pool=True` commits the resident streams for
  `cosine` and `specinfer`.
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
from repro.kernels.decode_attention.ops import decode_attention_paged
from repro.kernels.decode_attention.kernel import paged_flash_decode
from repro.kernels.decode_attention.ref import decode_attention_paged_ref
from repro.models import model as JM
from repro.serving.runner import ModelRunner as JaxRunner
from repro.serving.runner import PagedSlotCacheManager as JaxManager
from repro_torch import config as tconfig
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.kernels.paged_attention import ops as pa
from repro_torch.models import model as TM
from repro_torch.models.convert import params_from_numpy
from repro_torch.serving.engine import SpeculativeEngine
from repro_torch.serving.runner import ModelRunner, PagedSlotCacheManager


@pytest.fixture(scope="module", autouse=True)
def _fast_reference_compile():
    """The JAX package's programs compiled cheaply (`_jax_fast_compile`)."""
    with fast_compile():
        yield


MAX_LEN = 96


def _tcfg(cfg):
    cls = (tconfig.CoSineConfig if isinstance(cfg, CoSineConfig)
           else tconfig.ModelConfig)
    return cls(**{f.name: getattr(cfg, f.name)
                  for f in dataclasses.fields(cfg)})


def _swa():
    return tiny_model_cfg("attn").with_overrides(
        name="tiny-swa", attention="swa", sliding_window=16)


def _eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# ------------------------------------------------------------- the kernel

def _paged_fixture(rng, B, H, G, D, ps, lengths, extra_null=0):
    """Request b holds positions [0, L_b) on pages handed out in a
    scrambled order; pages 0 (scratch) and 1 (NULL) are reserved.
    Returns the reference layout (P, H, ps, D) as numpy."""
    n_pages = 2 + sum(-(-L // ps) for L in lengths)
    nv = max(-(-L // ps) for L in lengths)
    nv = (1 << (nv - 1).bit_length()) + extra_null
    q = rng.standard_normal((B, H, G, D)).astype(np.float32)
    k = rng.standard_normal((n_pages, H, ps, D)).astype(np.float32)
    v = rng.standard_normal((n_pages, H, ps, D)).astype(np.float32)
    pos = np.full((n_pages, ps), -1, np.int32)
    tbl = np.ones((B, nv), np.int32)              # NULL page filler
    free = list(rng.permutation(np.arange(2, n_pages)))
    for b, L in enumerate(lengths):
        for j in range(-(-L // ps)):
            n = min(ps, L - j * ps)
            page = int(free.pop())
            pos[page, :n] = j * ps + np.arange(n)
            tbl[b, j] = page
    qp = np.asarray([L - 1 for L in lengths], np.int32)
    return q, k, v, pos, qp, tbl


@pytest.mark.parametrize("window", [0, 16])
@pytest.mark.parametrize("G,ps", [(1, 8), (4, 16)])
def test_paged_plain_matches_reference_and_pallas(window, G, ps):
    rng = np.random.default_rng(G * 10 + ps)
    args = _paged_fixture(rng, B=3, H=2, G=G, D=16, ps=ps,
                          lengths=[25, 9, 31])
    jargs = [jnp.asarray(a) for a in args]
    ref = np.asarray(decode_attention_paged_ref(*jargs, scale=0.25,
                                                window=window))
    pal = np.asarray(decode_attention_paged(*jargs, scale=0.25,
                                            window=window, interpret=True))
    acc, m, l = pa.paged_flash_decode(*map(torch.from_numpy, args),
                                      scale=0.25, window=window)
    out = fa.finalize((m, l, acc)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(out, pal, rtol=1e-5, atol=1e-5)
    # the unnormalised partials too (the Pallas kernel pads G to 8 rows)
    pacc, pm, pl_ = paged_flash_decode(*jargs, scale=0.25, window=window,
                                       interpret=True)
    np.testing.assert_allclose(m.numpy(), np.asarray(pm), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(l.numpy(), np.asarray(pl_), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(acc.numpy(), np.asarray(pacc), rtol=1e-5,
                               atol=1e-5)
    assert pa.LAUNCHES == 0            # CPU tensors never launch


def test_null_pages_are_exact_noops():
    """Widening the view with NULL entries changes no bit."""
    rng = np.random.default_rng(1)
    q, k, v, pos, qp, tbl = _paged_fixture(rng, B=2, H=2, G=4, D=16, ps=8,
                                           lengths=[9, 17])
    wide = np.concatenate([tbl, np.ones((2, 4), np.int32)], axis=1)
    t = [torch.from_numpy(a) for a in (q, k, v, pos, qp)]
    a = pa.paged_flash_decode(*t, torch.from_numpy(tbl), scale=0.25)
    b = pa.paged_flash_decode(*t, torch.from_numpy(wide), scale=0.25)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.parametrize("ps", [16, 32, 64])
@pytest.mark.parametrize("window", [0, 20])
def test_multi_row_form_bitwise_on_gathered_view(ps, window):
    """T > 1 rows with per-token positions (verification's cache pass,
    commit, prefill): bitwise the resident plain version on the gathered
    view, for every page size."""
    gen = torch.Generator().manual_seed(ps + window)
    B, T, H, G, D, nv = 2, 6, 2, 3, 16, 4
    P = 2 + B * nv
    k = torch.randn((P, ps, H, D), generator=gen)
    v = torch.randn((P, ps, H, D), generator=gen)
    pos = torch.full((P, ps), -1, dtype=torch.int32)
    tbl = torch.ones((B, nv), dtype=torch.int32)
    lens = [2 * ps + 3, ps - 1]
    nxt = 2
    for b, L in enumerate(lens):
        for j in range(-(-L // ps)):
            n = min(ps, L - j * ps)
            pos[nxt, :n] = j * ps + torch.arange(n, dtype=torch.int32)
            tbl[b, j] = nxt
            nxt += 1
    q = torch.randn((B, T, H, G, D), generator=gen)
    qp = torch.tensor([[L - T + t for t in range(T)] for L in lens],
                      dtype=torch.int32).clamp(min=0)
    got = pa.paged_attend_partial(q, k, v, qp, pos, tbl, scale=0.25,
                                  window=window, block=fa.KEY_TILE)
    want = fa.attend_partial_plain(
        q, pa.gather_view(k, tbl), pa.gather_view(v, tbl), qp,
        pa.gather_view(pos, tbl), scale=0.25, window=window,
        block=fa.KEY_TILE)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


# ------------------------------------------------------------- the runners

@pytest.fixture(scope="module", params=["attn", "swa"])
def models(request):
    cfg = tiny_model_cfg("attn") if request.param == "attn" else _swa()
    tree = jax.tree.map(np.asarray, JM.init_params(jax.random.PRNGKey(0),
                                                   cfg))
    return cfg, _tcfg(cfg), tree, params_from_numpy(tree, _tcfg(cfg), "cpu")


def _runners(models, **paged_kw):
    cfg, tcfg, tree, tp = models
    paged_kw.setdefault("page_size", 16)
    res = ModelRunner(tcfg, tp, MAX_LEN, n_slots=2, device="cpu")
    pag = ModelRunner(tcfg, tp, MAX_LEN, n_slots=2, paged=True,
                      device="cpu", **paged_kw)
    jres = JaxRunner(cfg, jax.tree.map(jnp.asarray, tree), MAX_LEN,
                     n_slots=2)
    return res, pag, jres, cfg


def _same(res_out, pag_out, jax_out):
    _eq(res_out, pag_out)
    np.testing.assert_allclose(pag_out, jax_out, rtol=1e-4, atol=1e-4)


def _drive(res, pag, jres, cfg, rng):
    """Prefill three requests (the third grows the slots), decode, verify
    a tree, commit ragged chains and draft on snapshots, comparing every
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
    parent = [-1, 0, 1, 0, 3]
    mask = np.zeros((G, G), bool)
    depth = np.zeros(G, np.int32)
    for i in range(G):
        mask[i, i] = True
        if parent[i] >= 0:
            mask[i] |= mask[parent[i]]
            depth[i] = depth[parent[i]] + 1
    rel = np.broadcast_to(depth, (3, G))
    mk = np.broadcast_to(mask, (3, G, G))
    _same(*(r.verify(rids, vt, rel, mk) for r in (res, pag, jres)))
    commits = {0: [1, 2], 1: [3], 2: [4, 5, 6]}
    outs = [r.extend_committed(commits) for r in (res, pag, jres)]
    for rid in commits:
        _same(*(o[rid] for o in outs))
        assert res.length(rid) == pag.length(rid) == jres.length(rid)
    # drafting on snapshots: three decodes and a teacher-forced extension
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


def test_paged_steps_match_resident_and_jax(models):
    res, pag, jres, cfg = _runners(models)
    _drive(res, pag, jres, cfg, np.random.default_rng(0))
    assert pag.slots.n_slots == 4                 # the slots grew once
    # padded rows wrote into the scratch page, nothing into the NULL page
    for layer in pag.slots.cache["layers"]:
        assert bool((layer["self"]["slot_pos"][pag.slots.NULL_PAGE]
                     == -1).all())


def test_pool_growth_eviction_and_reuse(models):
    """A pool of 4 pages (2 usable) must grow while serving; evicting a
    request wipes and frees its pages, and a new tenant reusing them sees
    no stale keys."""
    res, pag, jres, cfg = _runners(models, pool_pages=4)
    layers = pag.slots.cache["layers"]
    rng = np.random.default_rng(1)
    rids = _drive(res, pag, jres, cfg, rng)
    assert pag.slots.n_page_growths >= 1
    held = pag.slots.pages_held()
    freed = [p for p in pag.slots.tables[1] if p >= 0]
    for r in (res, pag, jres):
        r.drop(1)
    assert pag.slots.pages_held() == held - len(freed)
    for layer in pag.slots.cache["layers"]:
        assert bool((layer["self"]["slot_pos"][freed] == -1).all())
    toks = rng.integers(0, cfg.vocab, 30)
    _same(*(r.prefill_request(9, toks)[0] for r in (res, pag, jres)))
    if not pag.slots.ring_pages:
        # full attention takes the freed pages back first
        assert set(freed) <= set(pag.slots.tables[9])
    live = [rids[0], rids[2], 9]
    step = rng.integers(0, cfg.vocab, 3)
    _same(*(r.decode(live, step)[0] for r in (res, pag, jres)))
    # growth put the new pools into the same layer dicts: no holder of the
    # cache keeps a stale pool
    assert pag.slots.cache["layers"] is layers
    assert TM.paged_pool_shape(pag.slots.cfg, pag.slots.cache) \
        == (pag.slots.n_pages, pag.slots.page_size)
    assert all(layer["self"]["k"].shape[0] == pag.slots.n_pages
               for layer in layers)


# ------------------------------------------------------------- the manager

def _ops_stream(rng, n_ops, max_rids=6):
    ops, live = [], set()
    for _ in range(n_ops):
        r = int(rng.integers(0, max_rids))
        kind = rng.choice(["admit", "write", "release"])
        if kind == "admit" and r not in live:
            ops.append(("admit", r))
            live.add(r)
        elif kind == "write" and r in live:
            ops.append(("write", r, int(rng.integers(1, 40))))
        elif kind == "release" and r in live:
            ops.append(("release", r))
            live.discard(r)
    return ops


def _replay(mgr, op):
    if op[0] == "admit":
        mgr.admit(op[1])
    elif op[0] == "write":
        mgr.prepare([op[1]], write=op[2])
        mgr.advance(op[1], op[2])
    else:
        mgr.release(op[1])


@pytest.mark.parametrize("kind", ["attn", "swa"])
@pytest.mark.parametrize("seed", range(6))
def test_manager_matches_reference(kind, seed):
    """Same admit/prepare/advance/release stream: the same block tables,
    free lists, pool sizes and views as the reference manager, and at
    every step no leak (mapped + free == usable pages) and no aliasing."""
    cfg = tiny_model_cfg("attn") if kind == "attn" else _swa()
    ref = JaxManager(cfg, MAX_LEN, n_slots=2, page_size=16, pool_pages=6)
    mgr = PagedSlotCacheManager(_tcfg(cfg), MAX_LEN, n_slots=2,
                                device="cpu", page_size=16, pool_pages=6)
    assert (mgr.page_size, mgr.ring_pages) == (ref.page_size, ref.ring_pages)
    for op in _ops_stream(np.random.default_rng(seed), 40):
        _replay(ref, op)
        _replay(mgr, op)
        assert mgr.tables == ref.tables
        assert mgr._free_pages == ref._free_pages
        assert mgr.host_len == ref.host_len
        assert mgr.n_pages == ref.n_pages
        mapped = [p for t in mgr.tables.values() for p in t if p >= 0]
        assert len(mapped) == len(set(mapped))
        assert not set(mapped) & set(mgr._free_pages)
        assert min(mapped, default=2) >= mgr._RESERVED
        assert mgr.pages_held() + len(mgr._free_pages) \
            == mgr.n_pages - mgr._RESERVED
        live = sorted(mgr.tables)
        if live:
            for extra in (0, 128):
                _eq(mgr.view(live, extra), ref.view(live, extra))
        assert mgr.fragmentation() == ref.fragmentation()
    for rid in list(mgr.tables):
        mgr.release(rid)
    assert mgr.pages_held() == 0
    assert len(mgr._free_pages) == mgr.n_pages - mgr._RESERVED


def test_windowed_tables_are_fixed_rings():
    mgr = PagedSlotCacheManager(_tcfg(_swa()), MAX_LEN, n_slots=2,
                                device="cpu", page_size=64)
    # ring capacity min(max_len, window + RING_MARGIN) = 96: the page
    # size halves from 64 to 32 to divide it
    assert (mgr.page_size, mgr.ring_pages) == (32, 3)
    mgr.admit(0)
    mgr.prepare([0], write=mgr.page_size * mgr.ring_pages + 5)
    mgr.advance(0, mgr.page_size * mgr.ring_pages + 5)
    assert len(mgr.tables[0]) == mgr.ring_pages
    assert mgr.pages_held() == mgr.ring_pages
    assert mgr.view([0]).shape == (1, mgr.ring_pages)


def test_views_are_memoised_on_the_device():
    mgr = PagedSlotCacheManager(_tcfg(tiny_model_cfg("attn")), MAX_LEN,
                                n_slots=2, device="cpu", page_size=16)
    for rid in (0, 1):
        mgr.admit(rid)
        mgr.prepare([rid], write=20)
        mgr.advance(rid, 20)
    a = mgr.view([0, 1])
    assert mgr.view([0, 1]) is a                   # one tensor per view
    mgr.prepare([0], write=20)                     # maps a new page
    mgr.advance(0, 20)
    b = mgr.view([0, 1])
    assert b is not a and b.dtype == torch.int32
    assert b.shape == (2, 4) and int(b[0, 2]) == mgr.tables[0][2]


def test_swa_prompt_past_ring_capacity_resident_and_paged():
    """A 300-token prompt past the sliding-window ring (window 16, ring
    capacity 144 at max_len 512), then three decodes: the resident and
    the paged runner (fixed page rings) within 1e-4 of the JAX resident
    runner at every step, the paged one bitwise the resident one (the
    reference's `test_padded_chunk_prefill_swa_prompt_past_ring_capacity`
    and `test_paged_swa_prompt_past_ring_capacity`)."""
    cfg = _swa()
    tree = jax.tree.map(np.asarray, JM.init_params(jax.random.PRNGKey(2),
                                                   cfg))
    tcfg, tp = _tcfg(cfg), params_from_numpy(tree, _tcfg(cfg), "cpu")
    res = ModelRunner(tcfg, tp, 512, device="cpu")
    pag = ModelRunner(tcfg, tp, 512, paged=True, page_size=16, device="cpu")
    jres = JaxRunner(cfg, jax.tree.map(jnp.asarray, tree), 512)
    rng = np.random.default_rng(4)
    toks = rng.integers(0, cfg.vocab, 300)
    _same(*(r.prefill_request(0, toks)[0] for r in (res, pag, jres)))
    assert res.slots.cache["layers"][0]["self"]["k"].shape[1] == 144
    for t in rng.integers(0, cfg.vocab, 3):
        _same(*(r.decode([0], np.asarray([int(t)]))[0]
                for r in (res, pag, jres)))
    assert res.length(0) == pag.length(0) == 303


# ------------------------------------------------------------- the engine

@pytest.mark.parametrize("strategy", ["cosine", "specinfer"])
def test_engine_paged_streams_equal_resident(strategy):
    tcfg = _tcfg(tiny_model_cfg("attn"))
    dcfg = tconfig.ModelConfig(name="tiny-draft", family="dense", n_layers=1,
                               d_model=48, n_heads=2, n_kv_heads=2,
                               head_dim=16, d_ff=96, vocab=50,
                               tie_embeddings=True, dtype="float32")
    tp = TM.init_params(tcfg, 0, device="cpu")
    drafters = [(dcfg, TM.init_params(dcfg, 1, device="cpu"), "d0"),
                (tcfg, tp, "d1")]
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, 50, n).tolist() for n in (8, 21, 5)]
    outs, iters = [], []
    for paged in (False, True):
        cos = tconfig.CoSineConfig(n_drafters=2, draft_len=4,
                                   drafters_per_request=2, tree_width=2,
                                   paged_pool=paged, page_size=16,
                                   pool_pages=4)
        eng = SpeculativeEngine((tcfg, tp), drafters, cos,
                                strategy=strategy, max_len=MAX_LEN, seed=0,
                                device="cpu")
        reqs = [eng.submit(p, max_new_tokens=12) for p in prompts]
        stats = eng.run()
        outs.append([list(map(int, r.generated)) for r in reqs])
        iters.append([rec.committed for rec in stats.records])
        if paged:
            assert eng.target.slots.n_page_growths > 0
            assert eng.target.slots.pages_held() == 0   # all released
    assert outs[0] == outs[1]
    assert iters[0] == iters[1]

