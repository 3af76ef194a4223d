"""The port's dense model against `repro.models.model`, through the
weight bridge.

The JAX `init_params` tree (numpy leaves, QKV biases and norm scales
perturbed so they matter) goes through `models.convert.params_from_numpy`;
both models then run the same numpy tokens. Logits and the cache rows
written are compared at float32 with rtol = atol = 1e-4 (the two
frameworks sum matrix products in different orders; the values are O(1)).
Slot steps compare real rows only: padding rows that share the scratch
slot write it in place in the port, so their outputs are undefined there
and never read.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _jax_fast_compile import fast_compile
from conftest import tiny_model_cfg
from repro.models import attention as JA
from repro.models import model as JM
from repro_torch.config import ModelConfig as TModelConfig
from repro_torch.models import attention as TA
from repro_torch.models import model as TM
from repro_torch.models.convert import params_from_numpy


@pytest.fixture(scope="module", autouse=True)
def _fast_reference_compile():
    """The JAX package's programs compiled cheaply (`_jax_fast_compile`)."""
    with fast_compile():
        yield


TOL = 1e-4
MAX_LEN = 40


def _tcfg(cfg):
    """The same configuration as the port's (copied) dataclass."""
    return TModelConfig(**{f: getattr(cfg, f)
                           for f in cfg.__dataclass_fields__})


@pytest.fixture(scope="module", params=["plain", "qkv_bias"])
def pair(request):
    cfg = tiny_model_cfg("attn")
    if request.param == "qkv_bias":
        cfg = cfg.with_overrides(qkv_bias=True, name="tiny-attn-bias")
    tree = jax.tree.map(np.asarray, JM.init_params(jax.random.PRNGKey(0), cfg))
    rng = np.random.default_rng(7)
    for stage in tree["stages"]:
        for sub in stage:
            for key in ("bq", "bk", "bv"):
                if key in sub["mixer"]:
                    sub["mixer"][key] = rng.standard_normal(
                        sub["mixer"][key].shape).astype(np.float32) * 0.3
            for ln in ("ln1", "ln2"):
                sub[ln]["scale"] = (1.0 + 0.2 * rng.standard_normal(
                    sub[ln]["scale"].shape)).astype(np.float32)
    jparams = jax.tree.map(jnp.asarray, tree)
    tparams = params_from_numpy(tree, _tcfg(cfg), "cpu")
    return cfg, _tcfg(cfg), jparams, tparams


def cache_from_numpy(tree, cfg):
    """The reference's stacked cache (numpy leaves) as the port's
    per-layer cache, on the CPU."""
    layers = []
    for (pattern, reps), stage in zip(TM.layer_plan(cfg), tree["stages"]):
        for r in range(reps):
            for j in range(len(pattern)):
                layers.append({key: {f: torch.tensor(np.array(a[r]))
                                     for f, a in sub.items()}
                               for key, sub in stage[j].items()})
    return {"layers": layers, "lengths": torch.tensor(tree["lengths"])}


def _close(t, j):
    np.testing.assert_allclose(t.detach().numpy() if torch.is_tensor(t)
                               else t, np.asarray(j), rtol=TOL, atol=TOL)


def _caches_close(tcache, jcache, cfg, rows=None):
    """Every layer's k, v, slot_pos (restricted to `rows`) and lengths."""
    jc = cache_from_numpy(jax.tree.map(np.asarray, jcache), cfg)
    sel = slice(None) if rows is None else torch.tensor(rows)
    for tl, jl in zip(tcache["layers"], jc["layers"]):
        for f in ("k", "v"):
            _close(tl["self"][f][sel], jl["self"][f][sel])
        assert torch.equal(tl["self"]["slot_pos"][sel],
                           jl["self"]["slot_pos"][sel])
    assert torch.equal(tcache["lengths"][sel], jc["lengths"][sel])


def _tokens(seed, shape, vocab):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


def _tree_mask(B, G, seed):
    """Random ancestor masks: node i's parent is a random earlier node."""
    rng = np.random.default_rng(seed)
    mask = np.zeros((B, G, G), bool)
    depth = np.zeros((B, G), np.int32)
    for b in range(B):
        for i in range(G):
            mask[b, i, i] = True
            if i:
                p = rng.integers(0, i)
                mask[b, i] |= mask[b, p]
                depth[b, i] = depth[b, p] + 1
    return mask, depth


def test_apply_logits(pair):
    cfg, tcfg, jp, tp = pair
    toks = _tokens(0, (2, 11), cfg.vocab)
    lj, _, _ = JM.apply(jp, cfg, jnp.asarray(toks))
    lt, _, _ = TM.apply(tp, tcfg, torch.tensor(toks))
    _close(lt, lj)


def test_prefill_decode_extend_verify(pair):
    """The plain-batch steps in sequence, logits and caches each time."""
    cfg, tcfg, jp, tp = pair
    B = 2
    jc = JM.init_cache(cfg, B, MAX_LEN, dtype=jnp.float32)
    tc = TM.init_cache(tcfg, B, MAX_LEN, dtype=torch.float32, device="cpu")
    toks = _tokens(1, (B, 9), cfg.vocab)
    lj, jc, _ = JM.prefill(jp, cfg, jnp.asarray(toks), jc)
    lt, tc, _ = TM.prefill(tp, tcfg, torch.tensor(toks), tc)
    _close(lt, lj)
    _caches_close(tc, jc, tcfg)

    nt = _tokens(2, (B, 1), cfg.vocab)
    lj, jc, _ = JM.decode_step(jp, cfg, jnp.asarray(nt), jc)
    lt, tc, _ = TM.decode_step(tp, tcfg, torch.tensor(nt), tc)
    _close(lt, lj)
    _caches_close(tc, jc, tcfg)

    mask, depth = _tree_mask(B, 6, 3)
    vt = _tokens(3, (B, 6), cfg.vocab)
    pos = np.asarray(jc["lengths"])[:, None] + depth
    lj, _, _ = JM.verify_chunk(jp, cfg, jnp.asarray(vt), jc,
                               positions=jnp.asarray(pos),
                               seg_mask=jnp.asarray(mask))
    lt, _, _ = TM.verify_chunk(tp, tcfg, torch.tensor(vt), tc,
                               positions=torch.tensor(pos),
                               seg_mask=torch.tensor(mask))
    _close(lt, lj)
    _caches_close(tc, jc, tcfg)          # no-commit scoring writes nothing

    et = _tokens(4, (B, 3), cfg.vocab)
    lj, jc, _ = JM.extend(jp, cfg, jnp.asarray(et), jc)
    lt, tc, _ = TM.extend(tp, tcfg, torch.tensor(et), tc)
    _close(lt, lj)
    _caches_close(tc, jc, tcfg)


def test_slot_steps(pair):
    """slot_extend (prefill with a token_mask suffix), slot_decode_step,
    slot_verify_chunk (tree mask) and a commit, on a resident pool with a
    padding row mapped to the scratch slot 0."""
    cfg, tcfg, jp, tp = pair
    pool = 5
    jc = JM.init_cache(cfg, pool, MAX_LEN, dtype=jnp.float32)
    tc = TM.init_cache(tcfg, pool, MAX_LEN, dtype=torch.float32, device="cpu")
    sidx = np.array([3, 1, 0, 0], np.int32)        # rows 2, 3: padding
    real, real_slots = [0, 1], [3, 1]
    js, ts = jnp.asarray(sidx), torch.tensor(sidx)

    toks = _tokens(5, (4, 8), cfg.vocab)
    tmask = np.zeros((4, 8), bool)
    tmask[0, :8] = True
    tmask[1, :5] = True                            # masked suffix of 3
    lj, jc, _ = JM.slot_extend(jp, cfg, jnp.asarray(toks), jc, js,
                               token_mask=jnp.asarray(tmask))
    lt, tc, _ = TM.slot_extend(tp, tcfg, torch.tensor(toks), tc, ts,
                               token_mask=torch.tensor(tmask))
    _close(lt[real], np.asarray(lj)[real])
    _caches_close(tc, jc, tcfg, rows=real_slots)

    nt = _tokens(6, (4, 1), cfg.vocab)
    lj, jc, _ = JM.slot_decode_step(jp, cfg, jnp.asarray(nt), jc, js)
    lt, tc, _ = TM.slot_decode_step(tp, tcfg, torch.tensor(nt), tc, ts)
    _close(lt[real], np.asarray(lj)[real])
    _caches_close(tc, jc, tcfg, rows=real_slots)

    mask, depth = _tree_mask(4, 7, 8)
    vt = _tokens(7, (4, 7), cfg.vocab)
    lj = JM.slot_verify_chunk(jp, cfg, jnp.asarray(vt), jc, js,
                              jnp.asarray(depth), jnp.asarray(mask))
    lt = TM.slot_verify_chunk(tp, tcfg, torch.tensor(vt), tc, ts,
                              torch.tensor(depth), torch.tensor(mask))
    _close(lt[real], np.asarray(lj)[real])
    _caches_close(tc, jc, tcfg, rows=real_slots)

    ct = _tokens(9, (4, 3), cfg.vocab)
    lj, jc, _ = JM.slot_extend(jp, cfg, jnp.asarray(ct), jc, js)
    lt, tc, _ = TM.slot_extend(tp, tcfg, torch.tensor(ct), tc, ts)
    _close(lt[real], np.asarray(lj)[real])
    _caches_close(tc, jc, tcfg, rows=real_slots)


def test_gather_scatter_concat_slots(pair):
    """Snapshot gather, scatter back and growth mirror the reference."""
    cfg, tcfg, jp, tp = pair
    jc = JM.init_cache(cfg, 4, MAX_LEN, dtype=jnp.float32)
    tc = TM.init_cache(tcfg, 4, MAX_LEN, dtype=torch.float32, device="cpu")
    sidx = np.array([2, 1], np.int32)
    toks = _tokens(10, (2, 6), cfg.vocab)
    _, jc, _ = JM.slot_extend(jp, cfg, jnp.asarray(toks), jc,
                              jnp.asarray(sidx))
    _, tc, _ = TM.slot_extend(tp, tcfg, torch.tensor(toks), tc,
                              torch.tensor(sidx))
    jsub = JM.gather_slots(jc, jnp.asarray(sidx))
    tsub = TM.gather_slots(tc, torch.tensor(sidx))
    _caches_close(tsub, jsub, tcfg)
    # take_rows: the same gather for one layer's cache
    rows = TA.take_rows(tc["layers"][0]["self"], torch.tensor(sidx))
    ref = JA.take_rows({f: v[0] for f, v in
                        jc["stages"][0][0]["self"].items()},
                       jnp.asarray(sidx))
    for f in ("k", "v", "slot_pos"):
        _close(rows[f], ref[f])
    # decoding on the snapshot never touches the pool
    before = [t["self"]["k"].clone() for t in tc["layers"]]
    TM.decode_step(tp, tcfg, torch.tensor(_tokens(11, (2, 1), cfg.vocab)),
                   tsub)
    for b, layer in zip(before, tc["layers"]):
        assert torch.equal(b, layer["self"]["k"])
    dst = np.array([3, 0], np.int32)
    jc2 = JM.scatter_slots(jc, jsub, jnp.asarray(dst))
    TM.scatter_slots(tc, TM.gather_slots(tc, torch.tensor(sidx)),
                     torch.tensor(dst))
    _caches_close(tc, jc2, tcfg)
    jbig = JM.concat_slots(jc2, JM.init_cache(cfg, 2, MAX_LEN,
                                              dtype=jnp.float32))
    tbig = TM.concat_slots(tc, TM.init_cache(tcfg, 2, MAX_LEN,
                                             dtype=torch.float32,
                                             device="cpu"))
    _caches_close(tbig, jbig, tcfg)


@pytest.mark.parametrize("norm_type,mlp_type", [("rms", "swiglu"),
                                                ("layer", "gelu")])
def test_layers_and_quantize_plain_path(norm_type, mlp_type):
    """Norms, head-wise RMS norm, RoPE, both MLPs and the plain weight
    products against the reference's, including JAX's bf16 x f32 -> f32
    promotion in `qdot` and the bf16 tied-logits product."""
    from repro.models import layers as JL
    from repro.models import quantize as JQ
    from repro_torch.models import layers as TL
    from repro_torch.models import quantize as TQ

    cfg = tiny_model_cfg("attn").with_overrides(norm_type=norm_type,
                                                mlp_type=mlp_type)
    tcfg = _tcfg(cfg)
    rng = np.random.default_rng(12)
    x = rng.standard_normal((2, 5, cfg.d_model)).astype(np.float32)
    norm = {"scale": rng.standard_normal(cfg.d_model).astype(np.float32)}
    if norm_type == "layer":
        norm["bias"] = rng.standard_normal(cfg.d_model).astype(np.float32)
    jn = {k: jnp.asarray(v) for k, v in norm.items()}
    tn = {k: torch.tensor(v) for k, v in norm.items()}
    _close(TL.apply_norm(tn, torch.tensor(x), tcfg),
           JL.apply_norm(jn, jnp.asarray(x), cfg))
    h = rng.standard_normal((2, 5, 4, 16)).astype(np.float32)
    sc = rng.standard_normal(16).astype(np.float32)
    _close(TL.rms_norm_headwise(torch.tensor(sc), torch.tensor(h)),
           JL.rms_norm_headwise(jnp.asarray(sc), jnp.asarray(h)))
    pos = rng.integers(0, 500, (2, 5)).astype(np.int32)
    _close(TL.apply_rope(torch.tensor(h), torch.tensor(pos), 1e4),
           JL.apply_rope(jnp.asarray(h), jnp.asarray(pos), 1e4))
    mlp = jax.tree.map(np.asarray, JL.mlp_params(jax.random.PRNGKey(3), cfg,
                                                 cfg.d_model, cfg.d_ff))
    _close(TL.apply_mlp({k: torch.tensor(v) for k, v in mlp.items()},
                        torch.tensor(x), tcfg),
           JL.apply_mlp({k: jnp.asarray(v) for k, v in mlp.items()},
                        jnp.asarray(x), cfg))
    # bf16 activations against f32 weights promote to an f32 product
    w = rng.standard_normal((cfg.d_model, 24)).astype(np.float32)
    xb_t = torch.tensor(x).to(torch.bfloat16)
    xb_j = jnp.asarray(x, jnp.bfloat16)
    out_t = TQ.qdot(xb_t, torch.tensor(w))
    assert out_t.dtype == torch.float32
    _close(out_t, JQ.qdot(xb_j, jnp.asarray(w)))
    emb = rng.standard_normal((30, cfg.d_model)).astype(np.float32)
    lt = TQ.tied_logits(torch.tensor(emb), xb_t)
    assert lt.dtype == torch.bfloat16
    # bf16 results of 64-term sums of O(1) products (|value| ~ 8, where a
    # bf16 ulp is 0.0625): the two frameworks may differ by a few ulps
    np.testing.assert_allclose(
        lt.float().numpy(),
        np.asarray(JQ.tied_logits(jnp.asarray(emb), xb_j), np.float32),
        rtol=2e-2, atol=2e-1)
    toks = rng.integers(0, 30, (2, 3)).astype(np.int32)
    _close(TQ.embed_lookup(torch.tensor(emb), torch.tensor(toks),
                           torch.float32),
           JQ.embed_lookup(jnp.asarray(emb), jnp.asarray(toks), jnp.float32))
