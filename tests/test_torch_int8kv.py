"""int8 KV caches (`kv_dtype="int8"`) of the PyTorch port against
`repro.models.attention`, the JAX resident runner and the JAX engine.

* `kv_rows` of an int8 cache (symmetric per-(token, head) scales, round
  half to even) and `dequantize_cache` are bitwise the reference's; the
  empty cache and page pool have the reference's leaves.
* The wrappers' plain versions read an int8 pool through the
  reference's dequantized bf16 view: bitwise the plain attention over
  that view, resident and paged.
* Model forwards with int8 KV (prefill, decode, tree verification,
  commit) match the JAX resident int8 path at 1e-4. The runners, through
  slot growth, page-pool growth, snapshots and eviction, are bitwise
  resident = paged on the CPU and within 1e-4 of the JAX resident
  runner. (Never bitwise against the JAX paged path: the reference's own
  `test_paged_int8_kv_matches_resident_int8` fails on this stack.)
* A `cosine` engine run with int8 KV for target and drafters commits the
  port's greedy stream and the JAX engine's; its paged run commits the
  resident run's tokens.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _jax_fast_compile import fast_compile
from conftest import tiny_model_cfg
from repro.config import CoSineConfig, ModelConfig
from repro.models import attention as JA
from repro.models import model as JM
from repro.serving.engine import SpeculativeEngine as JaxEngine
from repro.serving.runner import ModelRunner as JaxRunner
from repro_torch import config as tconfig
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.kernels.paged_attention import ops as pa
from repro_torch.models import attention as TA
from repro_torch.models import model as TM
from repro_torch.models.convert import params_from_numpy
from repro_torch.serving.engine import SpeculativeEngine
from repro_torch.serving.runner import ModelRunner
from test_torch_paged import _drive


@pytest.fixture(scope="module", autouse=True)
def _fast_reference_compile():
    """The JAX package's programs compiled cheaply (`_jax_fast_compile`)."""
    with fast_compile():
        yield


MAX_LEN = 96
NEW = 10
TOL = 1e-4


def _tcfg(cfg):
    cls = (tconfig.CoSineConfig if isinstance(cfg, CoSineConfig)
           else tconfig.ModelConfig)
    return cls(**{f.name: getattr(cfg, f.name)
                  for f in dataclasses.fields(cfg)})


def _int8(cfg):
    return cfg.with_overrides(kv_dtype="int8", name=cfg.name + "-kv8")


def _eq(t, j):
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def _close(t, j):
    np.testing.assert_allclose(t.detach().numpy() if torch.is_tensor(t)
                               else t, np.asarray(j), rtol=TOL, atol=TOL)


# ------------------------------------------------------- storage, bitwise

def _kv_inputs(seed, B=2, T=5, H=2, D=16):
    rng = np.random.default_rng(seed)
    k = (rng.standard_normal((B, T, H, D)) * 3).astype(np.float32)
    v = rng.standard_normal((B, T, H, D)).astype(np.float32)
    k[0, 0, 0] = 0.0                        # all-zero row: scale 1e-8
    k[0, 1, 1] = np.arange(D) - 7.5         # half-way ties, max |x| 8.5
    k[0, 1, 1, 0] = 127.0                   # -> scale 1, ties x.5
    v[1, 2, 0] = 1e-12                      # below the scale's floor
    return k, v


def test_make_kv_cache_int8_leaves_equal_reference():
    for t_c, j_c in ((TA.make_kv_cache(3, 8, 2, 16, quantized=True),
                      JA.make_kv_cache(3, 8, 2, 16, quantized=True)),
                     (TA.make_kv_cache(5, 4, 2, 16, quantized=True),
                      JA.make_paged_kv_cache(5, 4, 2, 16, quantized=True))):
        assert sorted(t_c) == sorted(j_c)
        for key in j_c:
            assert str(t_c[key].dtype).split(".")[-1] == str(j_c[key].dtype)
            _eq(t_c[key], j_c[key])


@pytest.mark.parametrize("seed", [0, 1])
def test_kv_rows_and_dequantized_view_bitwise_reference(seed):
    k, v = _kv_inputs(seed)
    pos = np.arange(10, dtype=np.int32).reshape(2, 5)
    jc = JA.make_kv_cache(2, 8, 2, 16, quantized=True)
    tc = TA.make_kv_cache(2, 8, 2, 16, quantized=True)
    jr = JA.kv_rows(jc, jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos))
    tr = TA.kv_rows(tc, torch.from_numpy(k), torch.from_numpy(v),
                    torch.from_numpy(pos))
    assert sorted(tr) == sorted(jr)
    for key in jr:
        assert str(tr[key].dtype).split(".")[-1] == str(jr[key].dtype)
        _eq(tr[key], jr[key])
    assert int(tr["k"][0, 1, 1, 0]) == 127
    # the bf16 view the plain versions (and the kernels) read
    jk, jv = JA.dequantize_cache(jr)
    tk, tv = TA.dequantize_cache(tr)
    assert tk.dtype == tv.dtype == torch.bfloat16
    _eq(tk.float(), np.asarray(jk, np.float32))
    _eq(tv.float(), np.asarray(jv, np.float32))


def test_plain_versions_read_the_dequantized_view():
    """Resident (through slot_idx) and paged (through a scrambled block
    table) int8 reads: bitwise the plain attention over the bf16 view."""
    gen = torch.Generator().manual_seed(0)
    P, S, H, G, D, T, ps = 4, 48, 2, 3, 16, 4, 16
    k8, ks = TA._quantize(torch.randn((P, S, H, D), generator=gen))
    v8, vs = TA._quantize(torch.randn((P, S, H, D), generator=gen))
    pos = torch.arange(S, dtype=torch.int32).repeat(P, 1)
    pos[:, 40:] = -1
    q = torch.randn((2, T, H, G, D), generator=gen)
    qp = (36 + torch.arange(T, dtype=torch.int32)).repeat(2, 1)
    sidx = torch.tensor([3, 1], dtype=torch.int32)
    kw = dict(scale=0.25, block=fa.KEY_TILE)
    got = fa.attend_partial(q, k8, v8, qp, pos, slot_idx=sidx, k_scale=ks,
                            v_scale=vs, **kw)
    want = fa.attend_partial_plain(q, fa.dequantize_kv(k8, ks),
                                   fa.dequantize_kv(v8, vs), qp, pos,
                                   slot_idx=sidx, **kw)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    # the same keys as a page pool: pages of slot 3, then of slot 1
    pages = lambda t: t.reshape((P * S // ps, ps) + t.shape[2:])   # noqa
    tbl = torch.tensor([[9, 10, 11], [3, 4, 5]], dtype=torch.int32)
    paged = pa.paged_attend_partial(q, pages(k8), pages(v8), qp, pages(pos),
                                    tbl, k_scale=pages(ks),
                                    v_scale=pages(vs), **kw)
    for a, b in zip(paged, got):
        assert torch.equal(a, b)
    assert fa.LAUNCHES == 0 and pa.LAUNCHES == 0     # CPU: no launch


# ------------------------------------------------------------- forwards

@pytest.fixture(scope="module")
def pair():
    cfg = _int8(tiny_model_cfg("attn"))
    tree = jax.tree.map(np.asarray, JM.init_params(jax.random.PRNGKey(0),
                                                   cfg))
    return cfg, _tcfg(cfg), tree, params_from_numpy(tree, _tcfg(cfg), "cpu")


def test_int8_cache_steps_match_jax(pair):
    """Prefill, decode, a tree verification (no commit; its fresh segment
    unquantized) and a chain commit on a plain batch cache: logits at
    1e-4, positions and lengths equal, scales within 1e-5."""
    cfg, tcfg, tree, tp = pair
    jp = jax.tree.map(jnp.asarray, tree)
    B = 2
    jc = JM.init_cache(cfg, B, 40, dtype=jnp.float32)
    tc = TM.init_cache(tcfg, B, 40, dtype=torch.float32, device="cpu")
    assert tc["layers"][0]["self"]["k"].dtype == torch.int8
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab, (B, 9)).astype(np.int32)
    lj, jc, _ = JM.prefill(jp, cfg, jnp.asarray(toks), jc)
    lt, tc, _ = TM.prefill(tp, tcfg, torch.tensor(toks), tc)
    _close(lt, lj)
    step = rng.integers(0, cfg.vocab, (B, 1)).astype(np.int32)
    lj, jc, _ = JM.decode_step(jp, cfg, jnp.asarray(step), jc)
    lt, tc, _ = TM.decode_step(tp, tcfg, torch.tensor(step), tc)
    _close(lt, lj)
    G = 4
    mask = np.tril(np.ones((G, G), bool))
    mask[3, 1:3] = False                     # node 3 hangs off node 0
    pos = np.asarray(jc["lengths"])[:, None] + np.array([0, 1, 2, 1])
    vt = rng.integers(0, cfg.vocab, (B, G)).astype(np.int32)
    lj, _, _ = JM.verify_chunk(jp, cfg, jnp.asarray(vt), jc,
                               positions=jnp.asarray(pos, jnp.int32),
                               seg_mask=jnp.asarray(np.broadcast_to(
                                   mask, (B, G, G))))
    lt, _, _ = TM.verify_chunk(tp, tcfg, torch.tensor(vt), tc,
                               positions=torch.tensor(pos, dtype=torch.int32),
                               seg_mask=torch.tensor(np.broadcast_to(
                                   mask, (B, G, G)).copy()))
    _close(lt, lj)
    ext = rng.integers(0, cfg.vocab, (B, 3)).astype(np.int32)
    lj, jc, _ = JM.extend(jp, cfg, jnp.asarray(ext), jc)
    lt, tc, _ = TM.extend(tp, tcfg, torch.tensor(ext), tc)
    _close(lt, lj)
    _eq(tc["lengths"], jc["lengths"])
    for (pattern, reps), stage in zip(TM.layer_plan(tcfg), jc["stages"]):
        for r in range(reps):
            for j in range(len(pattern)):
                jl = jax.tree.map(np.asarray, stage[j])["self"]
                tl = tc["layers"][r * len(pattern) + j]["self"]
                _eq(tl["slot_pos"], jl["slot_pos"][r])
                for key in ("k_scale", "v_scale"):
                    np.testing.assert_allclose(tl[key].numpy(), jl[key][r],
                                               rtol=1e-5, atol=1e-8)


@pytest.mark.parametrize("pool_pages", [0, 4])
def test_int8_runners_paged_bitwise_resident_and_near_jax(pair, pool_pages):
    """The runners' prefill, decode, tree verification, commit and
    snapshot drafting with int8 KV: paged bitwise resident, both within
    1e-4 of the JAX resident runner, through slot growth and (4 pages)
    page-pool growth; the scale leaves grow with the pools, snapshots
    carry them, and eviction frees the pages."""
    cfg, tcfg, tree, tp = pair
    res = ModelRunner(tcfg, tp, MAX_LEN, n_slots=2, device="cpu")
    pag = ModelRunner(tcfg, tp, MAX_LEN, n_slots=2, paged=True,
                      page_size=16, pool_pages=pool_pages, device="cpu")
    jres = JaxRunner(cfg, jax.tree.map(jnp.asarray, tree), MAX_LEN,
                     n_slots=2)
    rids = _drive(res, pag, jres, cfg, np.random.default_rng(pool_pages))
    assert res.slots.n_slots == pag.slots.n_slots == 4
    if pool_pages:
        assert pag.slots.n_page_growths >= 1
    for mgr, lead in ((res.slots, res.slots.n_slots + 1),
                      (pag.slots, pag.slots.n_pages)):
        for layer in mgr.cache["layers"]:
            c = layer["self"]
            assert c["k"].dtype == torch.int8
            assert c["k_scale"].shape[0] == c["v_scale"].shape[0] == lead
    snap = pag.speculative_caches(rids)
    assert all("k_scale" in layer["self"] for layer in snap["layers"])
    freed = [p for p in pag.slots.tables[rids[1]] if p >= 0]
    for r in (res, pag, jres):
        r.drop(rids[1])
    for layer in pag.slots.cache["layers"]:
        assert bool((layer["self"]["slot_pos"][freed] == -1).all())


# ------------------------------------------------------------- the engine

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
            [rec.committed for rec in stats.records], stats, eng)


def test_int8_kv_engine_is_greedy_exact_and_equals_jax(pair):
    """int8 KV for the target and both drafters (a random one and the
    target's weights): the port's streams equal its greedy decode and the
    JAX engine's (per-iteration commits too); on a paged pool that must
    grow they equal the resident streams."""
    cfg, tcfg, tree, tp = pair
    dcfg = _int8(ModelConfig(name="tiny-draft", family="dense", n_layers=1,
                             d_model=48, n_heads=2, n_kv_heads=2, head_dim=16,
                             d_ff=96, vocab=cfg.vocab, tie_embeddings=True,
                             dtype="float32"))
    dtree = jax.tree.map(np.asarray, JM.init_params(jax.random.PRNGKey(1),
                                                    dcfg))
    tdp = params_from_numpy(dtree, _tcfg(dcfg), "cpu")
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, cfg.vocab, n).tolist() for n in (8, 7)]
    t_drafters = [(_tcfg(dcfg), tdp, "d0"), (tcfg, tp, "d1")]
    streams = {}
    for paged in (False, True):
        cos = CoSineConfig(n_drafters=2, draft_len=4, drafters_per_request=2,
                           tree_width=2, paged_pool=paged, page_size=16,
                           pool_pages=4)
        streams[paged], iters, stats, eng = _serve(
            SpeculativeEngine, (tcfg, tp), t_drafters, _tcfg(cos), prompts,
            device="cpu")
        assert stats.mean_acceptance > 1.0
        if paged:
            assert eng.target.slots.n_page_growths > 0
        else:
            res_iters = iters
    assert streams[True] == streams[False]
    for stream, p in zip(streams[False], prompts):
        assert stream == _greedy(tcfg, tp, p, NEW)
    cos = CoSineConfig(n_drafters=2, draft_len=4, drafters_per_request=2,
                       tree_width=2)
    j_streams, j_iters, _, _ = _serve(
        JaxEngine, (cfg, tree), [(dcfg, dtree, "d0"), (cfg, tree, "d1")],
        cos, prompts)
    assert streams[False] == j_streams
    assert res_iters == j_iters
